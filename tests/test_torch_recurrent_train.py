"""The ssm and hybrid families' forward and training in the port against
the JAX package's (mamba2-1.3b and recurrentgemma-2b at their smoke
configs in float32, `tests/test_torch_recurrent.py` holds the rest):
from the same weights (`convert.train_params_from_numpy`, the hybrid's
"blocks" and "tail" unstacked) and SyntheticLM batches, the bypass
forward's logits within 1e-5 of the largest and its greedy tokens equal,
and 3 `make_train_step` steps in bypass and in fakequant within
`tests/test_torch_train.py`'s float32 tolerances (loss, CE and grad
norm; the parameters after the steps).

In fakequant an ulp of the float glue can move an activation code, and
AdamW's normalized update turns a small gradient difference into up to
2 lr of parameter: the steps drift apart step by step, and the RG-LRU
scan must round as XLA's does (`models/rglru.py`) for recurrentgemma's
third step to stay within the grad-norm tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.lm_data import LMDataConfig, SyntheticLM
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import AdamWConfig as JaxAdamW
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import steps
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from test_torch_recurrent import (ARCHS, B, LR, S, STEPS, TOLS, _configs,
                                  _rel, one_intra_op_thread)

__all__ = ["one_intra_op_thread"]


def _batches(cfg):
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B))
    return [dict(zip(("tokens", "labels"), data.batch_at(s)))
            for s in range(STEPS)]


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)).long() for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _runs(arch, mode):
    """Both packages from the same weights: the forward's logits and 3
    train steps."""
    jcfg, tcfg = _configs(arch, mode)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(1))
    tstate = steps.train_state(convert.train_params_from_numpy(
        jax.tree.map(np.array, jstate["params"])))
    batches = _batches(tcfg)
    jlogits = np.asarray(jax.jit(lambda p, t: jtf.forward(jcfg, p, t)[0])(
        jstate["params"], jnp.asarray(batches[0]["tokens"])))
    with torch.no_grad():
        tlogits = tf.forward(tcfg, tstate["params"],
                             _torch_batch(batches[0])["tokens"])[0]
    jstep = jax.jit(jsteps.make_train_step(jcfg, JaxAdamW(lr=LR),
                                           total_steps=10, warmup=2))
    tstep = steps.make_train_step(tcfg, AdamWConfig(lr=LR), total_steps=10,
                                  warmup=2)
    metrics = []
    for b in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        tstate, tm = tstep(tstate, _torch_batch(b))
        metrics.append({k: (float(jm[k]), float(tm[k]))
                        for k in ("loss", "ce", "aux", "grad_norm")})
    return {"logits": (jlogits, tlogits.float().numpy()), "metrics": metrics,
            "params": (tree_leaves(convert.train_params_from_numpy(
                jax.tree.map(np.array, jstate["params"]))),
                [p.detach() for p in tree_leaves(tstate["params"])])}


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ARCHS
                                       for m in ("bypass", "fakequant")])
def test_forward_and_train_steps_match_jax(arch, mode):
    tols = TOLS[mode]
    run = _runs(arch, mode)
    cfg = get_smoke_config(arch)
    jl, tl = run["logits"]
    assert tl.shape == (B, S, cfg.vocab_size) and np.isfinite(tl).all()
    if mode == "bypass":
        assert _rel(tl, jl) <= 1e-5
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    for m in run["metrics"]:
        for key, tol in (("loss", tols["loss"]), ("ce", tols["loss"]),
                         ("grad_norm", tols["gnorm"])):
            j, t = m[key]
            assert np.isfinite(t) and abs(j - t) <= tol * abs(j), (key, j, t)
        assert m["aux"] == (0.0, 0.0)
    jp, tp = run["params"]
    diffs = [(a - b).abs() for a, b in zip(jp, tp)]
    worst = max(float(d.max()) for d in diffs)
    mean = float(sum(d.sum() for d in diffs)) / sum(d.numel() for d in diffs)
    assert worst <= tols["p_max"] and mean <= tols["p_mean"], (worst, mean)

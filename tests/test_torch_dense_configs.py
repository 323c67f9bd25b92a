"""The three dense configs the port registers beside OLMo-1B (`granite_8b`,
`minitron_4b`, `qwen2_7b`) against the JAX package's.

- each `CONFIG` and `smoke_config()` equals JAX's field for field (the
  JAX `cim` field is held through its own fields), and `--arch` takes
  their names and aliases;
- the full config's parameter count equals JAX's `eval_shape` count,
  built under `FakeTensorMode` (meta-backed tensors: nothing allocated);
- at each smoke config, from the same weights (`convert.train_params_
  from_numpy`) and batch: the float32 bypass forward within rtol 1e-5 of
  the largest logit, and one `make_train_step` step's loss and grad norm,
  every gradient and every updated parameter within `tests/test_torch_
  train.py`'s bypass float32 tolerances; granite's fakequant step (JAX's
  `test_cim_fakequant_transformer`) within that file's fakequant ones,
  the ABN gradients held as one vector per kind (all gains, all offsets)
  at 0.3, as that file holds them in bfloat16: at granite's widths the
  w_down gains' residuals nearly cancel (a norm 30x below the other
  gains'), and that leaf alone reads as noise against JAX.  The flash
  attention (attn_impl "pallas") runs Pallas in interpret mode on the
  JAX side and the kernels' plain versions here;
- train/decode consistency (JAX's `test_train_decode_consistency`): the
  smoke config's bf16 logits of an 8-token forward and of 8 cached
  decode steps differ by less than 0.1.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core.cim_layers import CIMConfig as JaxCIM
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import AdamWConfig as JaxAdamW
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.launch import steps, train
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it: where pytest-xdist workers share the cores, PyTorch's pool spins
    at the barrier of each small CPU op (test_torch_sharding.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("granite_8b", "minitron_4b", "qwen2_7b")
ALIASES = {"granite_8b": "granite-8b", "minitron_4b": "minitron-4b",
           "qwen2_7b": "qwen2-7b"}
B, S = 2, 24
LR = 1e-3
# tests/test_torch_train.py's tolerances: loss and grad norm relative,
# each gradient's relative norm error, updated params max / mean abs
TOLS = {"bypass": dict(loss=1e-5, gnorm=1e-5, w=1e-4, p_max=1e-4,
                       p_mean=1e-6),
        "fakequant": dict(loss=5e-3, gnorm=2e-2, w=5e-2, abn_kind=0.3,
                          p_max=2 * LR, p_mean=1e-4)}


def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = ({g.name: getattr(v, g.name)
                        for g in dataclasses.fields(v)
                        if g.name not in ("noise", "macro", "sharding")}
                       if f.name == "cim" else v)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax(arch):
    assert arch in ARCH_IDS
    for port, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch)),
                      (get_config(ALIASES[arch]), jax_config(ALIASES[arch]))):
        assert _fields(port) == _fields(ref)
        assert port.resolved_head_dim == ref.resolved_head_dim
    args = train.parser().parse_args(["--arch", ALIASES[arch], "--smoke"])
    assert get_smoke_config(args.arch) == get_smoke_config(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count_equals_jax(arch):
    cfg = get_config(arch)
    shapes = jax.eval_shape(lambda: jtf.init_params(jax_config(arch),
                                                    jax.random.PRNGKey(0)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with FakeTensorMode():
        params = tf.init_params(cfg, torch.Generator())
        leaves = tree_leaves(params)
        got = sum(p.numel() for p in leaves)
    assert got == want > 1e9


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


def _configs(arch, mode, dtype="float32"):
    jcfg = jax_smoke(arch).replace(
        cim=JaxCIM(mode=mode, max_gamma=2.0**16), attn_impl="pallas",
        dtype=dtype)
    tcfg = get_smoke_config(arch).replace(
        cim=CIMConfig(mode=mode, max_gamma=2.0**16), attn_impl="pallas",
        dtype=dtype)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _step(arch, mode):
    """Both packages from the same weights: logits, step-0 gradients and
    one train step."""
    jcfg, tcfg = _configs(arch, mode)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(1))
    tstate = steps.train_state(convert.train_params_from_numpy(
        jax.tree.map(np.array, jstate["params"])))
    toks, labels = _batch(tcfg, 1)
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tbatch = {"tokens": torch.from_numpy(toks).long(),
              "labels": torch.from_numpy(labels).long()}
    jlogits = np.asarray(jax.jit(lambda p, t: jtf.forward(jcfg, p, t)[0])(
        jstate["params"], jbatch["tokens"]))
    with torch.no_grad():
        tlogits = tf.forward(tcfg, tstate["params"], tbatch["tokens"])[0]
    (_, _), jgrads = jax.jit(jax.value_and_grad(
        functools.partial(jsteps.loss_fn, jcfg), has_aux=True))(
        jstate["params"], jbatch)
    tloss, _ = steps.loss_fn(tcfg, tstate["params"], tbatch)
    tgrads = torch.autograd.grad(tloss, tree_leaves(tstate["params"]),
                                 allow_unused=True)
    jg = tree_leaves(convert.train_params_from_numpy(
        jax.tree.map(np.array, jgrads)))
    jstate, jm = jax.jit(jsteps.make_train_step(jcfg, JaxAdamW(lr=LR)))(
        jstate, jbatch)
    tstate, tm = steps.make_train_step(tcfg, AdamWConfig(lr=LR))(
        tstate, tbatch)
    names = _leaf_names(tstate["params"])
    return {"logits": (jlogits, tlogits.float().numpy()),
            "metrics": {k: (float(jm[k]), float(tm[k]))
                        for k in ("loss", "grad_norm")},
            "grads": list(zip(names, jg, [
                torch.zeros_like(a) if b is None else b.detach()
                for a, b in zip(jg, tgrads)])),
            "params": (tree_leaves(convert.train_params_from_numpy(
                jax.tree.map(np.array, jstate["params"]))),
                [p.detach() for p in tree_leaves(tstate["params"])])}


def _leaf_names(tree, pre=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k],
                                                              f"{pre}/{k}")]
    if isinstance(tree, list):
        return [n for i, t in enumerate(tree)
                for n in _leaf_names(t, f"{pre}/{i}")]
    return [pre]


CASES = [(a, "bypass") for a in ARCHS] + [("granite_8b", "fakequant")]


@pytest.mark.parametrize("arch,mode", CASES)
def test_smoke_forward_and_train_step_match_jax(arch, mode):
    tols = TOLS[mode]
    run = _step(arch, mode)
    jl, tl = run["logits"]
    assert tl.shape == (B, S, get_smoke_config(arch).vocab_size)
    assert np.isfinite(tl).all()
    if mode == "bypass":
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=1e-5 * float(np.abs(jl).max()))
    for key, tol in (("loss", tols["loss"]), ("grad_norm", tols["gnorm"])):
        j, t = run["metrics"][key]
        assert np.isfinite(t) and abs(j - t) <= tol * abs(j), (key, j, t)
    bad = []

    def hold(name, j, t, tol):
        err = float((j - t).norm()) / max(float(j.norm()), 1e-30)
        if err > tol:
            bad.append((name, err))

    for name, j, t in run["grads"]:
        if "abn_" not in name:
            hold(name, j, t, tols["w"])
        elif mode == "bypass":              # the ABN params are unused
            assert float(j.abs().max()) == 0.0 == float(t.abs().max())
    if mode == "fakequant":
        for kind in ("abn_log_gamma", "abn_beta"):
            js, ts = zip(*[(j.flatten(), t.flatten())
                           for n, j, t in run["grads"] if n.endswith(kind)])
            hold(f"every {kind}", torch.cat(js), torch.cat(ts),
                 tols["abn_kind"])
    assert not bad, bad
    jp, tp = run["params"]
    diffs = [(a - b).abs() for a, b in zip(jp, tp)]
    worst = max(float(d.max()) for d in diffs)
    mean = float(sum(d.sum() for d in diffs)) / sum(d.numel() for d in diffs)
    assert worst <= tols["p_max"] and mean <= tols["p_mean"], (worst, mean)
    assert all(bool(torch.isfinite(p).all()) for p in tp)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_decode_consistency(arch):
    cfg = get_smoke_config(arch)
    params = tf.init_params(cfg, torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, 8))).long()
    with torch.no_grad():
        full, _, _ = tf.forward(cfg, params, toks)
        cache = tf.init_cache(cfg, 1, max_len=16)
        outs = []
        for t in range(8):
            lg, cache, _ = tf.forward(cfg, params, toks[:, t:t + 1],
                                      cache=cache)
            outs.append(lg[:, 0])
    err = float((full.float() - torch.stack(outs, 1).float()).abs().max())
    assert err < 0.1, f"{arch}: train/decode divergence {err}"

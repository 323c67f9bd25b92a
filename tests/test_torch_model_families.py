"""The moe and vlm decoder families in the port against the JAX package's:
phi3.5-moe-42b-a6.6b, mixtral-8x22b and internvl2-76b.

- each `CONFIG` and `smoke_config()` equals JAX's field for field, the
  registry lists every JAX arch in JAX's order, an unknown arch or
  family raises ValueError, and so do encoder frames given to a family
  other than audio (the ssm and hybrid families are held in
  `tests/test_torch_recurrent.py`, the audio family in
  `tests/test_torch_audio.py`);
- the full configs' parameter counts equal JAX's `eval_shape` counts,
  built under `FakeTensorMode` (meta-backed tensors: nothing allocated);
- at each smoke config in float32, from the same weights
  (`convert.train_params_from_numpy`, the stacked (L, E, D, F) banks
  included) and SyntheticLM batches (internvl2 with a prefix of 8 patch
  embeddings): the bypass forward's logits within 1e-5 of the largest
  and its greedy tokens equal, and 3 `make_train_step` steps' loss, CE,
  aux and grad norm and the parameters after them within
  `tests/test_torch_train.py`'s tolerances (bypass float32 for all three
  archs, fakequant float32 for phi3.5);
- cached decode (prefill of the prefix for internvl2, then one token a
  step) equals the full forward within JAX's 0.1 in bfloat16
  (`tests/test_models_smoke.py::test_train_decode_consistency`);
- phi3.5's stack in the port: engine == fakequant bit for bit at (8, 4)
  and (1, 2) (`tests/test_llm_engine.py:141`);
- `quantize_params_for_serving` bit for bit on MoE trees, the deploy
  forward within 1e-5 of JAX's;
- under a mesh whose model axis is 2 fakequant raises NotImplementedError
  (JAX's shard_map path); a mesh of 1s and engine mode run the local
  path.

The serve loops against JAX are in `tests/test_torch_family_serve.py`.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.core import cim_layers as jcl
from repro.data.lm_data import LMDataConfig, SyntheticLM
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro.optim import AdamWConfig as JaxAdamW
from repro_torch import convert
from repro_torch.configs import (ARCH_IDS, ModelConfig, get_config,
                                 get_smoke_config)
from repro_torch.core import cim_layers as tcl
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps, train
from repro_torch.models import sharding as tsh
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


ARCHS = ("phi35_moe", "mixtral_8x22b", "internvl2_76b")
ALIASES = {"phi35_moe": "phi3.5-moe-42b-a6.6b",
           "mixtral_8x22b": "mixtral-8x22b", "internvl2_76b": "internvl2-76b"}
B, S = 2, 16
LR = 1e-3
STEPS = 3
# tests/test_torch_train.py's float32 tolerances: loss, CE, aux and grad
# norm relative, params max / mean abs after the steps
TOLS = {"bypass": dict(loss=1e-5, gnorm=1e-5, p_max=1e-4, p_mean=1e-6),
        "fakequant": dict(loss=5e-3, gnorm=2e-2, p_max=2 * LR * STEPS,
                          p_mean=1e-4)}


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
    assert get_config(arch).resolved_head_dim == 128
    args = train.parser().parse_args(["--arch", ALIASES[arch], "--smoke"])
    assert get_smoke_config(args.arch) == get_smoke_config(arch)


def test_registry_is_jax_order_without_the_unported():
    """Every JAX arch is registered, in JAX's order (whisper-medium, the
    last, with the audio family); a name or a family outside it raises
    ValueError, and so do encoder frames given to another family than
    audio, as a prefix given to another than vlm does."""
    assert ARCH_IDS == list(JAX_ARCH_IDS)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("whisper-large")
    cfg = ModelConfig(name="video", family="video", n_layers=1, d_model=8,
                      n_heads=1, n_kv_heads=1, d_ff=8, vocab_size=8)
    with pytest.raises(ValueError, match="unknown model family"):
        tf.init_params(cfg, torch.Generator())
    _, cfg = _configs("phi35_moe", "bypass")
    with pytest.raises(ValueError, match="audio"):
        tf.forward(cfg, tf.init_params(cfg, torch.Generator()),
                   torch.zeros((1, 2), dtype=torch.long),
                   encoder_frames=torch.zeros((1, 4, cfg.d_model)))


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count_equals_jax(arch):
    shapes = jax.eval_shape(lambda: jtf.init_params(jax_config(arch),
                                                    jax.random.PRNGKey(0)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with FakeTensorMode():
        params = tf.init_params(get_config(arch), torch.Generator())
        got = sum(p.numel() for p in tree_leaves(params))
    assert got == want > 4e10


def _configs(arch, mode, dtype="float32"):
    jcfg = jax_smoke(arch).replace(
        cim=jcl.CIMConfig(mode=mode, max_gamma=2.0**16), attn_impl="pallas",
        dtype=dtype)
    tcfg = get_smoke_config(arch).replace(
        cim=tcl.CIMConfig(mode=mode, max_gamma=2.0**16), attn_impl="pallas",
        dtype=dtype)
    return jcfg, tcfg


def _batches(cfg):
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                    global_batch=B))
    out = []
    for s in range(STEPS):
        toks, labels = data.batch_at(s)
        b = {"tokens": toks, "labels": labels}
        if cfg.family == "vlm":
            b["prefix_embeds"] = np.array(jax.random.normal(
                jax.random.PRNGKey(10 + s), (B, cfg.vision_tokens,
                                             cfg.d_model)))
        out.append(b)
    return out


def _torch_batch(b):
    return {k: (torch.from_numpy(np.array(v)).long() if k != "prefix_embeds"
                else torch.from_numpy(np.array(v))) for k, v in b.items()}


@functools.lru_cache(maxsize=None)
def _runs(arch, mode):
    """Both packages from the same weights: the forward's logits and 3
    train steps."""
    jcfg, tcfg = _configs(arch, mode)
    jstate = jsteps.init_train_state(jcfg, jax.random.PRNGKey(1))
    tstate = steps.train_state(convert.train_params_from_numpy(
        jax.tree.map(np.array, jstate["params"])))
    batches = _batches(tcfg)
    kw = ({"prefix_embeds": jnp.asarray(batches[0]["prefix_embeds"])}
          if tcfg.family == "vlm" else {})
    jlogits = np.asarray(jax.jit(lambda p, t: jtf.forward(
        jcfg, p, t, **kw)[0])(jstate["params"],
                              jnp.asarray(batches[0]["tokens"])))
    tb0 = _torch_batch(batches[0])
    with torch.no_grad():
        tlogits = tf.forward(tcfg, tstate["params"], tb0["tokens"],
                             prefix_embeds=tb0.get("prefix_embeds"))[0]
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


CASES = [(a, "bypass") for a in ARCHS] + [("phi35_moe", "fakequant")]


@pytest.mark.parametrize("arch,mode", CASES)
def test_forward_and_train_steps_match_jax(arch, mode):
    tols = TOLS[mode]
    run = _runs(arch, mode)
    cfg = get_smoke_config(arch)
    jl, tl = run["logits"]
    prefix = cfg.vision_tokens if cfg.family == "vlm" else 0
    assert tl.shape == (B, prefix + S, cfg.vocab_size)
    assert np.isfinite(tl).all()
    if mode == "bypass":
        np.testing.assert_allclose(tl, jl, rtol=0,
                                   atol=1e-5 * float(np.abs(jl).max()))
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    for m in run["metrics"]:
        for key, tol in (("loss", tols["loss"]), ("ce", tols["loss"]),
                         ("aux", tols["loss"]), ("grad_norm", tols["gnorm"])):
            j, t = m[key]
            assert np.isfinite(t) and abs(j - t) <= tol * abs(j), (key, j, t)
        if cfg.family == "moe":
            assert m["aux"][1] > 0
        else:
            assert m["aux"] == (0.0, 0.0)
    jp, tp = run["params"]
    diffs = [(a - b).abs() for a, b in zip(jp, tp)]
    worst = max(float(d.max()) for d in diffs)
    mean = float(sum(d.sum() for d in diffs)) / sum(d.numel() for d in diffs)
    assert worst <= tols["p_max"] and mean <= tols["p_mean"], (worst, mean)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_decode_consistency(arch):
    cfg = get_smoke_config(arch)
    params = tf.init_params(cfg, torch.Generator().manual_seed(2))
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         size=(1, 8))).long()
    prefix = None
    if cfg.family == "vlm":
        prefix = torch.from_numpy(rng.normal(size=(
            1, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
    with torch.no_grad():
        full, _, _ = tf.forward(cfg, params, toks, prefix_embeds=prefix)
        full = full[:, -8:]
        cache = tf.init_cache(cfg, 1, max_len=32)
        outs = []
        if prefix is not None:
            _, cache, _ = tf.forward(cfg, params, toks[:, :0],
                                     cache=cache, prefix_embeds=prefix)
        for t in range(8):
            lg, cache, _ = tf.forward(cfg, params, toks[:, t:t + 1],
                                      cache=cache)
            outs.append(lg[:, 0])
    err = float((full.float() - torch.stack(outs, 1).float()).abs().max())
    assert err < 0.1, f"{arch}: train/decode divergence {err}"


@pytest.mark.parametrize("r_in,r_w", [(8, 4), (1, 2)])
def test_phi35_moe_stack_engine_equals_fakequant(r_in, r_w):
    base = get_smoke_config("phi35_moe").replace(dtype="float32")
    fq = base.replace(cim=base.cim.replace(mode="fakequant", r_in=r_in,
                                           r_w=r_w))
    en = fq.replace(cim=fq.cim.replace(mode="engine"))
    params = tf.init_params(fq, torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, base.vocab_size, size=(2, 8))).long()
    with torch.no_grad():
        a = tf.forward(fq, params, toks)
        b = tf.forward(en, params, toks)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


@pytest.mark.parametrize("arch", ("phi35_moe", "mixtral_8x22b"))
def test_quantize_params_for_serving_matches_jax(arch):
    jcfg, tcfg = _configs(arch, "deploy")
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(3)))
    want = jax.tree.map(np.asarray, jcl.quantize_params_for_serving(
        jax.tree.map(jnp.asarray, tree), r_w=4))
    got = tcl.quantize_params_for_serving(
        convert.train_params_from_numpy(tree), r_w=4)
    conv = convert.deploy_params_from_numpy(want)
    moe = got["layers"][0]["moe"]
    assert moe["w_up_q"].dtype == torch.int8 and "w_up" not in moe
    assert moe["w_down_scale"].shape == (tcfg.moe_experts, tcfg.d_model)
    flat = jax.tree_util.tree_leaves_with_path(conv)
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for (path, w), g in zip(flat, jax.tree_util.tree_leaves(got)):
        assert w.dtype == g.dtype and torch.equal(w, g), path
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 8))
    jl = np.asarray(jax.jit(lambda p, t: jtf.forward(jcfg, p, t)[0])(
        jax.tree.map(jnp.asarray, want), jnp.asarray(toks)))
    with torch.no_grad():
        tl = tf.forward(tcfg, got, torch.from_numpy(toks).long())[0]
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=1e-5 * float(np.abs(jl).max()))


def test_mesh_splitting_the_experts_raises_in_fakequant():
    _, cfg = _configs("phi35_moe", "fakequant")
    params = tf.init_params(cfg, torch.Generator().manual_seed(5))
    toks = torch.zeros((2, 4), dtype=torch.long)
    with torch.no_grad():
        want = tf.forward(cfg, params, toks)[0]
        with tsh.use_mesh(tmesh.make_mesh((1, 2), ("data", "model"),
                                          fold_onto="cpu")):
            with pytest.raises(NotImplementedError, match="shard_map"):
                tf.forward(cfg, params, toks)
            en = cfg.replace(cim=cfg.cim.replace(mode="engine"))
            assert torch.equal(tf.forward(en, params, toks)[0], want)
        with tsh.use_mesh(tmesh.make_mesh((2, 1), ("data", "model"),
                                          fold_onto="cpu")):
            with pytest.raises(NotImplementedError, match="shard_map"):
                tf.forward(cfg, params, toks)
        with tsh.use_mesh(tmesh.make_mesh((1, 1), ("data", "model"),
                                          fold_onto="cpu")):
            assert torch.equal(tf.forward(cfg, params, toks)[0], want)


def test_prefix_embeds_are_the_vlm_input():
    _, cfg = _configs("olmo_1b", "bypass")
    with pytest.raises(ValueError, match="vlm"):
        tf.forward(cfg, tf.init_params(cfg, torch.Generator()),
                   torch.zeros((1, 2), dtype=torch.long),
                   prefix_embeds=torch.zeros((1, 1, cfg.d_model)))


def test_convert_carries_the_expert_banks():
    """train_params_from_numpy / deploy_params_from_numpy slice the
    stacked (L, E, D, F) banks, the router and the per-expert ABN per
    layer, bit for bit and dtype for dtype."""
    jcfg, tcfg = _configs("phi35_moe", "fakequant")
    tree = jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(6)))
    got = convert.train_params_from_numpy(tree)
    dq = convert.deploy_params_from_numpy(jax.tree.map(
        np.asarray, jcl.quantize_params_for_serving(
            jax.tree.map(jnp.asarray, tree))))
    e, d, f = tcfg.moe_experts, tcfg.d_model, tcfg.d_ff
    assert len(got["layers"]) == tcfg.n_layers
    for i, lay in enumerate(got["layers"]):
        moe = lay["moe"]
        assert tuple(moe["w_up"].shape) == (e, d, f)
        assert tuple(moe["w_down"].shape) == (e, f, d)
        assert tuple(moe["router"].shape) == (d, e)
        for k in ("router", "w_gate", "w_up", "w_down", "abn_log_gamma",
                  "abn_beta"):
            assert np.array_equal(moe[k].numpy(), tree["layers"]["moe"][k][i])
        assert dq["layers"][i]["moe"]["w_up_q"].dtype == torch.int8
    single = convert.moe_params_from_numpy(
        {k: v[0] for k, v in tree["layers"]["moe"].items()})
    assert all(torch.equal(single[k], got["layers"][0]["moe"][k])
               for k in single)

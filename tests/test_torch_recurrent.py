"""The ssm and hybrid families in the port against the JAX package's:
mamba2-1.3b and recurrentgemma-2b.

- each `CONFIG` and `smoke_config()` equals JAX's field for field, and
  the registry lists them in JAX's order;
- the full configs' parameter counts equal JAX's `eval_shape` counts,
  built under `FakeTensorMode` (nothing allocated);
- the sequence mixers from seeded numpy inputs: `ssd_chunked` (with and
  without an initial state, L not a multiple of the chunk) and
  `_causal_conv` with a state within 2e-5 of JAX's, `rglru_scan` (with
  h0, L up to 4096) equal to jitted JAX's bit for bit (the same
  association, each product-sum rounded once as XLA's CPU code fuses it);
- at each smoke config in float32, from the same weights
  (`convert.train_params_from_numpy`, the hybrid's "blocks" and "tail"
  unstacked): the forward and 3 train steps in
  `tests/test_torch_recurrent_train.py`;
- the stack in engine == fakequant bit for bit;
- per-token decode against the cache-free forward within JAX's 0.1 in
  bfloat16 (`tests/test_models_smoke.py::test_train_decode_consistency`);
- the port's cached prefill of 8 tokens, and of 5 then 3 tokens, within
  1e-5 of the largest logit of JAX's cache-free forward; JAX's own
  cached prefill is more than 1e-2 away (reference fault 11: its state
  branch runs one step for every token), which the port does not follow;
- the static serve loop (`serve.static_serve`, bypass, float32) against
  JAX's cached forward with the prompt fed one token a step: greedy
  tokens equal and logits within 1e-5 of the largest;
- `stacked_decay_mask` of a hybrid tree equals JAX's `ndim >= 2` mask
  over the stacked tree; `quantize_params_for_serving` equals JAX's bit
  for bit on both trees, conv_w / w_a / w_x / lam / A_log untouched;
  `cache_from_numpy` carries JAX's caches leaf for leaf;
- the launchers: a static engine serve on the CPU with no growth after
  warm-up; `--inflight`, a slot cache, a noise key and `--cim-noise`
  refused as JAX refuses them.
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
from repro.models import mamba2 as jm2
from repro.models import rglru as jrg
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core import cim_layers as tcl
from repro_torch.core import prng
from repro_torch.launch import serve, train
from repro_torch.models import mamba2 as tm2
from repro_torch.models import rglru as trg
from repro_torch.models import transformer as tf
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


ARCHS = ("mamba2_1_3b", "recurrentgemma_2b")
ALIASES = {"mamba2_1_3b": "mamba2-1.3b",
           "recurrentgemma_2b": "recurrentgemma-2b"}
B, S = 2, 16
LR = 1e-3
STEPS = 3
# tests/test_torch_train.py's float32 tolerances: loss, CE and grad norm
# relative, params max / mean abs after the steps
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


def _configs(arch, mode, dtype="float32", attn="pallas"):
    kw = dict(mode=mode, max_gamma=2.0**16)
    return (jax_smoke(arch).replace(cim=jcl.CIMConfig(**kw), attn_impl=attn,
                                    dtype=dtype),
            get_smoke_config(arch).replace(cim=tcl.CIMConfig(**kw),
                                           attn_impl=attn, dtype=dtype))


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _rel(got, want):
    """Largest |got - want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jax_params(arch, seed=0):
    jcfg, _ = _configs(arch, "bypass")
    return jax.tree.map(np.asarray, jtf.init_params(
        jcfg, jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_jax(arch):
    assert arch in ARCH_IDS
    for port, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke(arch)),
                      (get_config(ALIASES[arch]), jax_config(ALIASES[arch]))):
        assert _fields(port) == _fields(ref)
        if ref.n_heads:
            assert port.resolved_head_dim == ref.resolved_head_dim
    assert ARCH_IDS == list(JAX_ARCH_IDS)
    if arch == "recurrentgemma_2b":
        assert get_config(arch).resolved_head_dim == 256


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_count_equals_jax(arch):
    shapes = jax.eval_shape(lambda: jtf.init_params(jax_config(arch),
                                                    jax.random.PRNGKey(0)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with FakeTensorMode():
        params = tf.init_params(get_config(arch), torch.Generator())
        got = sum(p.numel() for p in tree_leaves(params))
    assert got == want > 1e9


# ---------------------------------------------------------------------------
# the sequence mixers
# ---------------------------------------------------------------------------

def _ssd_inputs(bsz, length, h, p, g, n, seed):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((bsz, length, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, length, h)))).astype(
        np.float32)
    a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bm, cm = (rng.standard_normal((bsz, length, g, n)).astype(np.float32)
              for _ in range(2))
    s0 = rng.standard_normal((bsz, h, p, n)).astype(np.float32)
    return xh, dt, a, bm, cm, s0


@pytest.mark.parametrize("length,chunk,g,init", [
    (37, 8, 1, False), (37, 8, 1, True), (64, 16, 2, True),
    (100, 16, 1, False)])
def test_ssd_chunked_matches_jax(length, chunk, g, init):
    xh, dt, a, bm, cm, s0 = _ssd_inputs(2, length, 4, 8, g, 16, length)
    j_init = jnp.asarray(s0) if init else None
    jy, js = jm2.ssd_chunked(*map(jnp.asarray, (xh, dt, a, bm, cm)),
                             chunk=chunk, init_state=j_init)
    ty, ts = tm2.ssd_chunked(*map(_t, (xh, dt, a, bm, cm)), chunk=chunk,
                             init_state=_t(s0) if init else None)
    for got, want in ((ty, jy), (ts, js)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    # the port's oracle agrees with its chunked form (tests/test_ssd_rglru)
    ny, ns = tm2.ssd_naive(*map(_t, (xh, dt, a, bm, cm)),
                           init_state=_t(s0) if init else None)
    np.testing.assert_allclose(ty.numpy(), ny.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(ts.numpy(), ns.numpy(), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("with_state", (False, True))
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32)
    jy, jst = jm2._causal_conv(*map(jnp.asarray, (x, w, b)),
                               jnp.asarray(st) if with_state else None)
    ty, tst = tm2._causal_conv(*map(_t, (x, w, b)),
                               _t(st) if with_state else None)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


@pytest.mark.parametrize("length,h0", [(1, True), (37, False), (40, True),
                                       (4096, True)])
def test_rglru_scan_matches_jax(length, h0):
    rng = np.random.default_rng(length)
    a = (1 / (1 + np.exp(-rng.standard_normal((2, length, 5))))).astype(
        np.float32)
    b = rng.standard_normal((2, length, 5)).astype(np.float32)
    hz = rng.standard_normal((2, 5)).astype(np.float32)
    want = np.asarray(jax.jit(jrg.rglru_scan)(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(hz) if h0 else None))
    got = trg.rglru_scan(_t(a), _t(b), _t(hz) if h0 else None).numpy()
    np.testing.assert_array_equal(got, want)


def test_softplus_is_jax_form():
    """logaddexp(x, 0) as JAX writes it: within 2 ulp of XLA's (its log1p
    is its own polynomial), and XLA flushes the subnormal softplus(-100)
    to 0."""
    x = np.array([-100.0, -20.5, -1.0, 0.0, 0.3, 19.0, 25.0, 90.0],
                 np.float32)
    np.testing.assert_allclose(trg.softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=2.4e-7, atol=1e-37)


# ---------------------------------------------------------------------------
# the stack, decode and serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_stack_engine_equals_fakequant(arch):
    _, fq = _configs(arch, "fakequant")
    en = fq.replace(cim=fq.cim.replace(mode="engine"))
    params = tf.init_params(fq, torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, fq.vocab_size, size=(2, 8))).long()
    with torch.no_grad():
        a = tf.forward(fq, params, toks)
        b = tf.forward(en, params, toks)
    assert torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_decode_consistency(arch):
    cfg = get_smoke_config(arch)
    assert cfg.dtype == "bfloat16"
    params = tf.init_params(cfg, torch.Generator().manual_seed(2))
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(1, 8))).long()
    with torch.no_grad():
        full = tf.forward(cfg, params, toks)[0]
        cache = tf.init_cache(cfg, 1, max_len=16)
        outs = []
        for t in range(8):
            lg, cache, _ = tf.forward(cfg, params, toks[:, t:t + 1],
                                      cache=cache)
            outs.append(lg[:, 0])
    err = float((full.float() - torch.stack(outs, 1).float()).abs().max())
    assert err < 0.1, f"{arch}: train/decode divergence {err}"


@functools.lru_cache(maxsize=None)
def _prefills(arch):
    """JAX's cache-free logits of 8 tokens, JAX's cached prefill of them,
    and the port's cached prefills (8 tokens; 5 then 3), float32 caches,
    the same weights."""
    jcfg, tcfg = _configs(arch, "bypass", attn="jnp")
    jp = _jax_params(arch)
    toks = np.random.default_rng(5).integers(0, tcfg.vocab_size, (1, 8))
    free = np.asarray(jtf.forward(jcfg, jax.tree.map(jnp.asarray, jp),
                                  jnp.asarray(toks))[0])
    jcache = jtf.init_cache(jcfg, 1, max_len=16, dtype=jnp.float32)
    jcached = np.asarray(jtf.forward(jcfg, jax.tree.map(jnp.asarray, jp),
                                     jnp.asarray(toks), cache=jcache)[0])
    params = convert.train_params_from_numpy(jp)
    tt = torch.from_numpy(toks).long()
    with torch.no_grad():
        cache = tf.init_cache(tcfg, 1, max_len=16, dtype=torch.float32)
        whole = tf.forward(tcfg, params, tt, cache=cache)[0]
        cache = tf.init_cache(tcfg, 1, max_len=16, dtype=torch.float32)
        a, cache, _ = tf.forward(tcfg, params, tt[:, :5], cache=cache)
        b, cache, _ = tf.forward(tcfg, params, tt[:, 5:], cache=cache)
    assert int(cache["pos"]) == 8
    return free, jcached, whole.numpy(), torch.cat([a, b], 1).numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_cached_prefill_matches_jax_cache_free(arch):
    free, _, whole, split = _prefills(arch)
    assert _rel(whole, free) <= 1e-5
    assert _rel(split, free) <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_cached_prefill_is_reference_fault_11(arch):
    """JAX's cached forward over more than one token is not its cache-free
    forward (mamba2_layer's state branch updates from token 0 only;
    rglru_block's applies a_t * h0 + b_t to every t): ROADMAP Queue 3,
    reference fault 11.  Position 0 agrees; later ones do not.  The port
    runs the recurrence (test_cached_prefill_matches_jax_cache_free)."""
    free, jcached, whole, _ = _prefills(arch)
    assert _rel(jcached[:, :1], free[:, :1]) <= 1e-5
    assert float(np.abs(jcached - free).max()) > 1e-2
    assert float(np.abs(whole - free).max()) < 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_static_serve_matches_jax_token_by_token(arch):
    """serve.static_serve (one cached prefill of the prompt, then greedy
    steps) against JAX's cached forward fed the prompt one token a step
    (the form of its serve loop that runs the recurrence), bypass float32,
    bf16 K/V rings on both sides."""
    jcfg, tcfg = _configs(arch, "bypass", attn="jnp")
    jp = _jax_params(arch)
    prompt = np.random.default_rng(6).integers(0, tcfg.vocab_size, (2, 6))
    gen, max_len = 4, serve.serve_max_len(tcfg, 6, 4)
    step = jax.jit(lambda p, c, t: jtf.forward(jcfg, p, t, cache=c)[:2])
    jparams = jax.tree.map(jnp.asarray, jp)
    cache = jtf.init_cache(jcfg, 2, max_len=max_len)
    for t in range(prompt.shape[1]):
        lg, cache = step(jparams, cache, jnp.asarray(prompt[:, t:t + 1]))
    jlogits, jtoks = [np.asarray(lg[:, -1])], [np.asarray(lg[:, -1]).argmax(
        -1)]
    for _ in range(gen):
        lg, cache = step(jparams, cache, jnp.asarray(jtoks[-1])[:, None])
        jlogits.append(np.asarray(lg[:, -1]))
        jtoks.append(jlogits[-1].argmax(-1))
    out = serve.static_serve(tcfg, convert.train_params_from_numpy(jp),
                             torch.from_numpy(prompt).long(), gen,
                             max_len=max_len, keep_logits=True)
    np.testing.assert_array_equal(out["tokens"].numpy(),
                                  np.stack(jtoks, 1))
    for got, want in zip(out["logits"], jlogits):
        assert _rel(got.numpy(), want) <= 1e-5


# ---------------------------------------------------------------------------
# trees: decay mask, serving quantization, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decay_mask_follows_the_stacked_jax_leaves(arch):
    """AdamW decays a leaf with ndim >= 2 as JAX stores it: the blocks'
    and the tail's 1-D leaves (biases, Lambda, norms, ABN) are stacked,
    so decayed; the final norm is not."""
    jp = _jax_params(arch)
    want = convert.deploy_params_from_numpy(jax.tree.map(
        lambda a: np.full(a.shape, a.ndim >= 2), jp))
    _, tcfg = _configs(arch, "bypass")
    got = tf.stacked_decay_mask(convert.train_params_from_numpy(jp))
    w_leaves, g_leaves = tree_leaves(want), tree_leaves(got)
    assert len(w_leaves) == len(g_leaves)
    for w, g in zip(w_leaves, g_leaves):
        assert bool(w.all()) == bool(w.any()) == g
    assert got["final_norm"]["scale"] is False
    stack = got["blocks"][0] if arch == "recurrentgemma_2b" \
        else got["layers"][0]
    assert all(tree_leaves(stack))
    if arch == "recurrentgemma_2b":
        assert all(tree_leaves(got["tail"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_quantize_params_for_serving_matches_jax(arch):
    jcfg, tcfg = _configs(arch, "deploy")
    tree = _jax_params(arch)
    want = jax.tree.map(np.asarray, jcl.quantize_params_for_serving(
        jax.tree.map(jnp.asarray, tree), r_w=4))
    got = tcl.quantize_params_for_serving(
        convert.train_params_from_numpy(tree), r_w=4)
    conv = convert.deploy_params_from_numpy(want)
    flat, leaves = tree_leaves(conv), tree_leaves(got)
    assert len(flat) == len(leaves)
    for w, g in zip(flat, leaves):
        assert w.dtype == g.dtype and torch.equal(w, g)
    if arch == "recurrentgemma_2b":
        rec = got["blocks"][0]["rec1"]["rec"]
        assert rec["w_rnn"]["w_q"].dtype == torch.int8
        kept = ("conv_w", "w_a", "w_x", "lam", "b_a", "conv_b")
        assert got["tail"][1]["rec"]["w_out"]["w_q"].dtype == torch.int8
    else:
        rec = got["layers"][0]["mixer"]
        assert rec["in_proj"]["w_q"].dtype == torch.int8
        kept = ("conv_w", "A_log", "D_skip", "dt_bias", "gate_norm")
    for k in kept:
        assert rec[k].dtype == torch.float32
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (2, 8))
    jl = np.asarray(jax.jit(lambda p, t: jtf.forward(jcfg, p, t)[0])(
        jax.tree.map(jnp.asarray, want), jnp.asarray(toks)))
    with torch.no_grad():
        tl = tf.forward(tcfg, got, torch.from_numpy(toks).long())[0]
    assert _rel(tl.numpy(), jl) <= 1e-5


@pytest.mark.parametrize("arch,n_layers", [("mamba2_1_3b", 2),
                                           ("recurrentgemma_2b", 5),
                                           ("recurrentgemma_2b", 6)])
def test_cache_from_numpy_carries_jax_caches(arch, n_layers):
    jcfg, tcfg = _configs(arch, "bypass")
    jcfg, tcfg = (c.replace(n_layers=n_layers) for c in (jcfg, tcfg))
    want = jax.tree.map(np.asarray, jtf.init_cache(jcfg, 2, max_len=24))
    if arch == "recurrentgemma_2b":
        assert (want["layers"]["tail"] is None) == (n_layers % 3 == 0)
    got = convert.cache_from_numpy(want)
    mine = tf.init_cache(tcfg, 2, max_len=24)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(mine)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(mine)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# launchers and what the families refuse
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("mamba2-1.3b", "recurrentgemma-2b"))
def test_serve_launcher_static_engine_on_the_cpu(arch, capsys):
    base = ["--arch", arch, "--smoke", "--device", "cpu", "--cim-mode",
            "engine", "--prompt-len", "8", "--gen-len", "3", "--batch", "2"]
    serve.main(base + ["--assert-no-recompile"])
    assert "plans=0 captures=0" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(base + ["--inflight"])


@pytest.mark.parametrize("arch", ARCHS)
def test_families_refuse_what_jax_refuses(arch):
    _, cfg = _configs(arch, "fakequant")
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="noise-keyed"):
        tf.forward(cfg, params, toks, key=prng.key(0))
    with pytest.raises(ValueError, match="attention-cache"):
        tf.init_slot_cache(cfg, 2, 16)
    args = train.parser().parse_args([
        "--arch", ALIASES[arch], "--smoke", "--device", "cpu", "--steps",
        "1", "--seq-len", "8", "--batch", "1", "--cim-mode", "fakequant",
        "--cim-noise"])
    _, state, step_fn, batch_fn = train.build(args)
    with pytest.raises(ValueError, match="noise-keyed"):
        step_fn(state, batch_fn(0), train.step_key(args, 0))


def test_train_launcher_trains_both_families_on_the_cpu():
    for arch in ALIASES.values():
        args = train.parser().parse_args([
            "--arch", arch, "--smoke", "--steps", "2", "--seq-len", "16",
            "--batch", "2", "--cim-mode", "fakequant", "--attn-impl",
            "pallas", "--device", "cpu"])
        cfg, state, step_fn, batch_fn = train.build(args)
        losses = []
        for s in range(2):
            state, m = step_fn(state, batch_fn(s))
            losses.append(float(m["loss"]))
        assert all(np.isfinite(losses)) and int(state["opt"]["step"]) == 2

"""The port's LM serving path against the JAX package's, on the CPU:
`transformer.forward(cache=)` in modes bypass, fakequant and engine, the
engine-mode projections on bound programs, deploy-quantized params, the
in-flight loop and the `launch/serve.py` launcher.  OLMo-1B's smoke
config (2 layers, d 64, 4 heads, vocab 512); the same weights carried
across with `convert.train_params_from_numpy`, prompts from numpy at a
fixed seed.  The JAX side runs jitted, with its engine's Pallas kernel in
interpret mode (as `tests/test_llm_engine.py` runs it); the port runs its
kernels' plain versions.

What is held, and to what:

- a prefill (2 x 8 tokens) and 4 greedy decode steps, each package
  decoding its own tokens: the greedy tokens equal JAX's in every mode
  and dtype.  The logits, as |port - JAX| / |JAX| over each step's
  (B, V) logits: in bypass float32 within 1e-5 at every step (about
  5e-7 read).  In fakequant and engine float32 the same 1e-5 holds at
  every step but one: the float glue between projections (norm, RoPE,
  softmax, SiLU) rounds differently in XLA and PyTorch by an ulp on
  many elements (both are correctly ordered float32; neither is
  wrong), and where such an ulp crosses a rounding boundary it moves
  an activation code by one, which moves that step's logits by about
  4e-3 (read on decode step 3); that step is held within 2e-2.  In
  bfloat16 every step within 0.1 (at most 2.95e-2 read, bypass 8.5e-3).
- engine == fakequant bit for bit over the whole stack with a cache in
  the port, at the grid points of JAX's
  `test_olmo_decoder_stack_engine_bitexact_vs_fakequant` (r_in {1,2,4,8}
  x r_w {1,2,4}) in float32, and at (8, 4) in bfloat16 (where the JAX
  package's own engine and fakequant differ: its contract test runs
  float32 only);
- `quantize_params_for_serving` bit for bit, and the deploy-mode forward
  (an untied, deploy-quantized head included) within 1e-5;
- the bound-program cache: a second call binds nothing, an in-place
  weight change re-binds and equals a fresh bind, every result equals
  per-call binding (`CIMProgram.serve`) bit for bit, and an entry
  leaves with its weight tensor;
- the in-flight loop: each request's tokens equal its solo decode;
- the launcher exits 0 with `--assert-no-recompile` (static and
  `--inflight`), and raises without a card or on what is not ported.
"""
import functools
import gc
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.core import cim_layers as jcl
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import cim_layers as tcl
from repro_torch.core import mapping, prng
from repro_torch.core.noise_model import NoiseConfig
from repro_torch.launch import serve
from repro_torch.models import transformer as ttf
from repro_torch.runtime import program as tprog


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it: where pytest-xdist workers share the cores, PyTorch's pool spins
    at the barrier of each small CPU op (test_torch_sharding.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parent.parent
B, P, GEN, MAX_LEN = 2, 8, 4, 16
GRID = [(r_in, r_w) for r_in in (1, 2, 4, 8) for r_w in (1, 2, 4)]
# |port - JAX| / |JAX| of a step's logits
REL_TOL = {"float32": 1e-5, "bfloat16": 0.1}
CODE_MOVE_TOL = 2e-2      # float32 fakequant / engine: one step may move


def _prompt(seed=0):
    return np.random.default_rng(seed).integers(0, 512, size=(B, P))


def _cfgs(mode, dtype, **cim):
    jcfg = jax_smoke("olmo_1b").replace(
        cim=jcl.CIMConfig(mode=mode, max_gamma=2.0**16, **cim), dtype=dtype)
    tcfg = get_smoke_config("olmo_1b").replace(
        cim=tcl.CIMConfig(mode=mode, max_gamma=2.0**16, **cim), dtype=dtype)
    return jcfg, tcfg


@functools.lru_cache(maxsize=None)
def _jax_params(mode, dtype):
    jcfg, _ = _cfgs(mode, dtype)
    return jax.tree.map(np.asarray, jtf.init_params(jcfg,
                                                    jax.random.PRNGKey(0)))


def _jax_decode(mode, dtype):
    """JAX: prefill + GEN greedy steps -> (logits per step as float32
    numpy (B, V), tokens (B, 1 + GEN))."""
    jcfg, _ = _cfgs(mode, dtype)
    params = jax.tree.map(jnp.asarray, _jax_params(mode, dtype))
    fwd = jax.jit(lambda p, t, c: jtf.forward(jcfg, p, t, cache=c)[:2])
    logits, cache = fwd(params, jnp.asarray(_prompt(), jnp.int32),
                        jtf.init_cache(jcfg, B, MAX_LEN))
    out, toks = [], []
    for _ in range(GEN + 1):
        out.append(np.asarray(logits[:, -1].astype(jnp.float32)))
        tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        if len(toks) <= GEN:
            logits, cache = fwd(params, tok, cache)
    return out, np.concatenate(toks, axis=1)


def _port_decode(tcfg, params, gen=GEN):
    out = serve.static_serve(tcfg, params, torch.from_numpy(_prompt()),
                             gen, max_len=MAX_LEN, keep_logits=True)
    return [lg.float().numpy() for lg in out["logits"]], \
        out["tokens"].numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["bypass", "fakequant", "engine"])
def test_forward_cache_matches_jax(mode, dtype):
    _, tcfg = _cfgs(mode, dtype)
    want, want_toks = _jax_decode(mode, dtype)
    got, got_toks = _port_decode(
        tcfg, convert.train_params_from_numpy(_jax_params(mode, dtype)))
    np.testing.assert_array_equal(got_toks, want_toks)
    rel = [float(np.linalg.norm(g - w) / np.linalg.norm(w))
           for g, w in zip(got, want)]
    tol = REL_TOL[dtype]
    if dtype == "float32" and mode != "bypass":
        assert sum(r > tol for r in rel) <= 1, rel
        assert max(rel) <= CODE_MOVE_TOL, rel
    else:
        assert max(rel) <= tol, rel


def _engine_vs_fakequant(r_in, r_w, dtype, gen):
    _, fq = _cfgs("fakequant", dtype, r_in=r_in, r_w=r_w)
    en = fq.replace(cim=fq.cim.replace(mode="engine"))
    params = ttf.init_params(fq, torch.Generator().manual_seed(r_in * 7
                                                               + r_w))
    a, ta = _port_decode(fq, params, gen)
    b, tb = _port_decode(en, params, gen)
    np.testing.assert_array_equal(ta, tb)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("r_in,r_w", GRID)
def test_engine_equals_fakequant_with_cache(r_in, r_w):
    _engine_vs_fakequant(r_in, r_w, "float32", 2)


def test_engine_equals_fakequant_with_cache_bf16():
    _engine_vs_fakequant(8, 4, "bfloat16", 3)


@pytest.mark.parametrize("r_w", [2, 4])
def test_quantize_params_for_serving_matches_jax(r_w):
    tree = _jax_params("fakequant", "float32")
    want = jax.tree.map(np.asarray, jcl.quantize_params_for_serving(
        jax.tree.map(jnp.asarray, tree), r_w=r_w))
    got = tcl.quantize_params_for_serving(
        convert.train_params_from_numpy(tree), r_w=r_w)
    conv = convert.deploy_params_from_numpy(want)
    assert got["layers"][0]["attn"]["wq"]["w_q"].dtype == torch.int8
    flat_w = jax.tree_util.tree_leaves_with_path(conv)
    assert len(flat_w) == len(jax.tree_util.tree_leaves(got))
    for (path, w), g in zip(flat_w, jax.tree_util.tree_leaves(got)):
        assert w.dtype == g.dtype and torch.equal(w, g), path


def test_prefill_and_serve_steps():
    """make_prefill_step returns the last position's logits of a
    cache-free forward; make_serve_step the greedy next token of a cached
    one and the cache it advanced."""
    from repro_torch.launch import steps
    _, cfg = _cfgs("engine", "float32")
    params = ttf.init_params(cfg, torch.Generator().manual_seed(6))
    toks = torch.from_numpy(_prompt(3))
    with torch.no_grad():
        full = ttf.forward(cfg, params, toks)[0]
        assert torch.equal(steps.make_prefill_step(cfg)(
            params, {"tokens": toks}), full[:, -1])
        want, want_cache, _ = ttf.forward(
            cfg, params, toks, cache=ttf.init_cache(cfg, B, MAX_LEN))
        nxt, cache = steps.make_serve_step(cfg)(
            params, ttf.init_cache(cfg, B, MAX_LEN), toks)
    assert torch.equal(nxt, torch.argmax(want[:, -1:], dim=-1))
    assert int(cache["pos"]) == P
    for k in ("k", "v", "idx"):
        assert torch.equal(cache["layers"]["kv"][k],
                           want_cache["layers"]["kv"][k])
    np.testing.assert_array_equal(cache["layers"]["kv"]["idx"].numpy(), P)


def test_deploy_forward_matches_jax():
    """Deploy mode with an untied head (lm_logits' deploy branch)."""
    jcfg, tcfg = _cfgs("deploy", "float32")
    jcfg, tcfg = (c.replace(tie_embeddings=False) for c in (jcfg, tcfg))
    jp = jcl.quantize_params_for_serving(
        jtf.init_params(jcfg, jax.random.PRNGKey(1)))
    want = jax.jit(lambda p, t: jtf.forward(jcfg, p, t)[0])(
        jp, jnp.asarray(_prompt(1), jnp.int32))
    tp = convert.deploy_params_from_numpy(jax.tree.map(np.asarray, jp))
    assert "w_q" in tp["lm_head"]
    got, cache, aux = ttf.forward(tcfg, tp, torch.from_numpy(_prompt(1)))
    assert cache is None and float(aux) == 0.0
    want = np.asarray(want)
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < 1e-5


def _layer(seed, k=40, n=24):
    g = torch.Generator().manual_seed(seed)
    return tcl.init_cim_linear(g, k, n, cfg=tcl.CIMConfig())


def test_bound_program_cache():
    cfg = tcl.CIMConfig(mode="engine", r_in=4, r_w=2)
    p = _layer(0)
    x = torch.randn((2, 3, 40), generator=torch.Generator().manual_seed(1))
    prog = tprog.compile_program(
        [mapping.LayerSpec(m=8, k=40, n=24, r_in=4, r_w=2)],
        tcl._engine_config(cfg), device="cpu")
    st0 = tprog.bound_cache_stats()
    y1 = tcl.cim_linear_apply(p, x, cfg)
    st1 = tprog.bound_cache_stats()
    assert st1["binds"] == st0["binds"] + 1
    y2 = tcl.cim_linear_apply(p, x, cfg)
    st2 = tprog.bound_cache_stats()
    assert st2["binds"] == st1["binds"] and st2["hits"] == st1["hits"] + 1
    assert torch.equal(y1, y2)
    bound = tprog.bound_for(prog, p)
    assert bound is tprog.bound_for(prog, p)
    # equal to binding on every call
    assert torch.equal(y1.reshape(6, 24), prog.serve([p], x.reshape(6, 40)))
    # another bucket of the same layer shares the bind products
    tcl.cim_linear_apply(p, x[:1, :1], cfg)
    assert tprog.bound_cache_stats()["binds"] == st2["binds"]
    # an in-place change re-binds and equals a fresh bind
    with torch.no_grad():
        p["w"].mul_(-0.5)
    y3 = tcl.cim_linear_apply(p, x, cfg)
    st3 = tprog.bound_cache_stats()
    assert st3["rebinds"] == st2["rebinds"] + 1
    fresh = {k: v.clone() for k, v in p.items()}
    assert torch.equal(y3, tcl.cim_linear_apply(fresh, x, cfg))
    assert not torch.equal(y3, y1)
    assert tprog.bound_for(prog, p) is not bound
    # a replaced ABN tensor re-binds too
    p["abn_beta"] = p["abn_beta"] + 1.0
    y4 = tcl.cim_linear_apply(p, x, cfg)
    assert tprog.bound_cache_stats()["rebinds"] == st3["rebinds"] + 1
    assert torch.equal(y4.reshape(6, 24), prog.serve([p], x.reshape(6, 40)))
    # the entry leaves with its weight tensor
    n_live = tprog.bound_cache_stats()["weights"]
    del p, fresh, bound
    gc.collect()
    assert tprog.bound_cache_stats()["weights"] <= n_live - 2


def test_engine_layer_refuses_sharding_and_sim():
    """The sharded engine layer is ported (tests/test_torch_sharding.py
    holds it bit for bit): it refuses a sharding that is not a runtime
    ShardingConfig, and one whose partitions need more devices than the
    host shows, in the linear and the conv layer alike."""
    from repro_torch.runtime.engine import ShardingConfig
    p, x = _layer(1), torch.zeros((1, 40))
    conv_p, conv_x = {**p, "w": p["w"][:36]}, torch.zeros((1, 3, 3, 4))
    for sharding, err, msg in ((object(), TypeError, "ShardingConfig"),
                               (ShardingConfig(devices=2), ValueError,
                                "devices")):
        cfg = tcl.CIMConfig(mode="engine", sharding=sharding)
        with pytest.raises(err, match=msg):
            tcl.cim_linear_apply(p, x, cfg)
        with pytest.raises(err, match=msg):
            tcl.cim_conv2d_apply(conv_p, conv_x, cfg)
    # the sim mode is ported (tests/test_torch_cim_macro.py)
    assert tcl.cim_linear_apply(p, x, tcl.CIMConfig(mode="sim")).shape \
        == (1, p["w"].shape[1])


def test_engine_forward_under_a_noise_key():
    """As JAX's test_olmo_engine_noise_deterministic: the same key gives
    the same logits, another key and the clean run differ; a noisy
    engine layer without a key raises."""
    _, cfg = _cfgs("engine", "float32", r_in=4, r_w=2, noise=NoiseConfig())
    params = ttf.init_params(cfg, torch.Generator().manual_seed(4))
    toks = torch.from_numpy(_prompt(2))[:1]
    a = ttf.forward(cfg, params, toks, key=prng.key(321))[0]
    assert torch.equal(a, ttf.forward(cfg, params, toks,
                                      key=prng.key(321))[0])
    assert not torch.equal(a, ttf.forward(cfg, params, toks,
                                          key=prng.key(9))[0])
    with pytest.raises(ValueError, match="PRNG key"):
        ttf.forward(cfg, params, toks)


def test_inflight_tokens_equal_solo_decode():
    _, cfg = _cfgs("engine", "bfloat16", isolate_rows=True)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(5))
    reqs = serve.make_requests(cfg.vocab_size, 6, 6, 5, seed=3)
    fused = serve.inflight_serve(cfg, params, reqs, 3, max_len=19,
                                 device="cpu")
    assert set(fused["tokens"]) == {r["uid"] for r in reqs}
    assert len(set(fused["slot"].values())) > 1     # batchmates existed
    for r in reqs:
        toks = fused["tokens"][r["uid"]]
        assert len(toks) == r["gen"]
        solo = serve.inflight_serve(cfg, params, [dict(r, arrival=0)], 3,
                                    max_len=19, device="cpu")
        assert solo["tokens"][r["uid"]] == toks, r["uid"]


def _launch(*extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "olmo-1b", "--smoke", "--device", "cpu", "--cim-mode", "engine",
         "--prompt-len", "8", "--gen-len", "4", "--batch", "2",
         "--assert-no-recompile", *extra],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("extra", [(), ("--inflight",)])
def test_launcher_runs_on_the_host(extra):
    out = _launch(*extra)
    assert out.returncode == 0, out.stderr
    assert "plans=0 captures=0" in out.stdout


def test_launcher_refuses_what_is_not_ported():
    base = ["--arch", "olmo-1b", "--smoke"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(base + ["--cim-mode", "engine"])
    # --engine-devices is ported: D real devices (the host shows one), and
    # engine mode only
    with pytest.raises(ValueError, match="devices"):
        serve.main(base + ["--device", "cpu", "--cim-mode", "engine",
                           "--engine-devices", "2"])
    with pytest.raises(SystemExit):
        serve.main(base + ["--device", "cpu", "--engine-devices", "2"])
    # --precision-policy is ported: it refuses, as the JAX launcher does,
    # anything but --cim-mode engine --inflight
    with pytest.raises(SystemExit) as exc:
        serve.main(base + ["--device", "cpu", "--precision-policy", "mixed"])
    assert exc.value.code == 2
    # the audio family's frames and the vlm family's prefix are ported,
    # and another family refuses them
    with pytest.raises(ValueError, match="audio"):
        ttf.forward(get_smoke_config("olmo_1b"), {}, torch.zeros(
            (1, 1), dtype=torch.long), encoder_frames=torch.zeros(1))
    with pytest.raises(ValueError, match="vlm"):
        ttf.forward(get_smoke_config("olmo_1b"), {}, torch.zeros(
            (1, 1), dtype=torch.long), prefix_embeds=torch.zeros(1))

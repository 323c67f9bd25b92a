"""The port's noise model, calibration and noise-injected engine against
the JAX package, bit for bit.

What the port is held to is the JAX source's own rounded chain: the
noise model's scalars in float32 where the JAX engine's traced
`NoiseConfig` leaves are float32, every product and sum rounded as the
source writes it.  JAX's `jit` rewrites that chain inside the engine
(XLA folds `x * c1 / c2` into one constant, turns a divide by a constant
into a reciprocal multiply, reassociates `gamma * g0 * gain_mult` and
contracts multiply-adds on the CPU; see `test_jax_jit_rewrites_the_
noise_chain` and ROADMAP Queue 3), so the engine comparisons run the
JAX side with `jax.disable_jit()` and float32 leaves: op by op, each op
compiled alone (`jax.random.normal`'s erf_inv included, whose XLA code
the port copies).  The jitted JAX engine agrees with the port on these
random inputs too (`test_noisy_engine_matches_jitted_jax_on_random_
inputs`), but that is not the contract.

Sizes follow `tests/test_engine_noise.py`: single-layer engines over
r_in {1, 2, 4, 8} x r_w {1, 2, 4}, a layer with K > 1152 and several
col tiles, LeNet at batch 2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import mapping as jmap
from repro.core import noise_model as jnm
from repro.models import cnn as jcnn
from repro.runtime import engine as jrt
from repro.runtime import program as jprog
from repro_torch.convert import key_from_numpy, params_from_numpy
from repro_torch.core import calibration as tcal
from repro_torch.core import mapping as tmap
from repro_torch.core import noise_model as tnm
from repro_torch.core import prng
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.models import cnn as tcnn
from repro_torch.runtime import engine as trt
from repro_torch.runtime import program as tprog

import torch_threads


one_intra_op_thread = pytest.fixture(autouse=True, scope="module")(
    torch_threads.one_intra_op_thread)


R_INS = (1, 2, 4, 8)
R_WS = (1, 2, 4)
THERMAL_ONLY = dict(sa_sigma_v=0.0, kappa_in=0.0, kappa_acc=0.0,
                    leak_v_per_us=0.0, tau0_ns=1e-4, tau_per_unit_ns=0.0)


def _same(a, b) -> bool:
    a = np.asarray(a)
    b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) \
        else np.asarray(b)
    if a.dtype == np.float32 or b.dtype == np.float32:
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                     b.view(np.int32))
    return a.shape == b.shape and np.array_equal(a, b)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _f32_leaves(noise: jnm.NoiseConfig) -> jnm.NoiseConfig:
    """The JAX config with float32 leaves, as the engine's jit sees it."""
    return noise.replace(**{f: jnp.float32(getattr(noise, f))
                            for f in tnm.LEAF_FIELDS})


def _seeded_params(dims, seed):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(0, k ** -0.5, size=(k, n)).astype(np.float32),
             "abn_log_gamma": rng.uniform(-1, 5, size=n).astype(np.float32),
             "abn_beta": rng.uniform(-4, 4, size=n).astype(np.float32)}
            for k, n in dims]


# ---- the noise model and calibration ---------------------------------------

def test_noise_config_mirrors_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jnm.NoiseConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tnm.NoiseConfig)}
    assert jf == tf
    assert tnm.NoiseConfig.none() == tnm.NO_NOISE
    assert not tnm.NO_NOISE.enabled
    assert tnm.NoiseConfig().replace(kappa_in=0.5).kappa_in == 0.5
    assert set(tnm.LEAF_FIELDS) == set(jnm._NOISE_LEAF_FIELDS)
    lv = tnm.leaves(tnm.NoiseConfig())
    assert all(getattr(lv, f).dtype == torch.float32
               and getattr(lv, f).device.type == "cpu"
               for f in tnm.LEAF_FIELDS)


@pytest.mark.parametrize("calibrated", (True, False))
def test_noise_model_functions_match_jax(calibrated):
    jn, tn = jnm.NoiseConfig(calibrated=calibrated), \
        tnm.NoiseConfig(calibrated=calibrated)
    k, tk = _jkey(5), prng.key(5)
    assert tnm.lsb8_volts() == jnm.lsb8_volts()
    assert tnm.thermal_sigma_v(tn, tnm.DEFAULT_MACRO) == \
        jnm.thermal_sigma_v(jn, jnm.DEFAULT_MACRO)
    for r_out, g0 in ((8, 0.37), (6, 1.3e-4), (1, 2.0)):
        assert tnm.thermal_sigma_dp(tn, r_out, g0) == \
            jnm.thermal_sigma_dp(jn, r_out, g0)
    assert _same(jnm.sample_sa_offsets(k, 256, jn),
                 tnm.sample_sa_offsets(tk, 256, tn))
    assert _same(jnm.sample_thermal(k, (5, 7), jn),
                 tnm.sample_thermal(tk, (5, 7), tn))
    for n, r_w in ((300, 2), (16, 4), (64, 1), (1, 3)):
        assert _same(jnm.sample_column_residues(k, n, r_w, jn),
                     tnm.sample_column_residues(tk, n, r_w, tn))
        assert tnm.channels_per_col_tile(r_w) == \
            jnm.channels_per_col_tile(r_w)
    assert _same(jnm.settle_fraction(jnp.arange(1, 33), 5.0, jn),
                 tnm.settle_fraction(torch.arange(1, 33), 5.0, tn))
    assert _same(jnm.settle_fraction(7, 3.5, jn),
                 tnm.settle_fraction(7, 3.5, tn))
    for r_in in range(1, 9):
        assert tnm.charge_injection_gain(r_in, tn) == \
            jnm.charge_injection_gain(r_in, jn)
        assert tnm.leakage_droop(r_in, 5.0, tn) == \
            jnm.leakage_droop(r_in, 5.0, jn)
    v = np.random.default_rng(0).uniform(0, 0.8, (2, 9)).astype(np.float32)
    assert _same(jnm.charge_injection_error(jnp.asarray(v), jnp.asarray(v.T[
        :1].T), jn), tnm.charge_injection_error(torch.from_numpy(v),
                                                 torch.from_numpy(v.T[:1].T),
                                                 tn))


def test_disabled_noise_model_is_neutral_like_jax():
    jn, tn = jnm.NO_NOISE, tnm.NO_NOISE
    z = tnm.sample_thermal(prng.key(0), (3, 2), tn, dtype=torch.bfloat16)
    assert z.dtype == torch.bfloat16 and not z.any()
    assert not tnm.sample_sa_offsets(prng.key(0), 8, tn).any()
    assert tnm.thermal_sigma_dp(tn, 8, 1.0) == 0.0
    assert tnm.charge_injection_gain(4, tn) == 0.0
    assert tnm.leakage_droop(4, 5.0, tn) == 0.0
    assert _same(jnm.settle_fraction(jnp.arange(3), 5.0, jn),
                 tnm.settle_fraction(torch.arange(3), 5.0, tn))
    e = tnm.charge_injection_error(torch.ones(4), torch.ones(1), tn)
    assert tuple(e.shape) == (4,) and not e.any()


def test_float32_leaves_match_jax_float32_leaves():
    """The engine's arithmetic: float32 leaves on both sides, eager."""
    jl, tl = _f32_leaves(jnm.NoiseConfig()), tnm.leaves(tnm.NoiseConfig())
    for r_in in (1, 4, 8):
        assert _same(jnm.charge_injection_gain(r_in, jl),
                     tnm.charge_injection_gain(r_in, tl))
        assert _same(jnm.leakage_droop(r_in, 5.0, jl),
                     tnm.leakage_droop(r_in, 5.0, tl))
    for units in (1, 4, 32):
        assert _same(jnm.settle_fraction(units, 5.0, jl),
                     tnm.settle_fraction(units, 5.0, tl))
    assert _same(jnm.thermal_sigma_dp(jl, 6, 0.37),
                 tnm.thermal_sigma_dp(tl, 6, 0.37))


def test_calibration_matches_jax():
    raw = np.asarray(jnm.sample_sa_offsets(_jkey(3), 2048, jnm.NoiseConfig()))
    raw = np.concatenate([raw, np.float32([0.0, 0.06, -0.06, 0.2, -0.2,
                                           0.47e-3, -1e-9])])
    t = torch.from_numpy(raw)
    assert _same(jcal.calibrate_sar(jnp.asarray(raw)), tcal.calibrate_sar(t))
    assert _same(jcal.residual_offsets(jnp.asarray(raw)),
                 tcal.residual_offsets(t))
    for r_out in (1, 4, 8):
        assert _same(jcal.dysfunctional_columns(jnp.asarray(raw), r_out),
                     tcal.dysfunctional_columns(t, r_out))
    # Fig. 19: in-range offsets reduce to within 2 calibration LSBs
    res = tcal.residual_offsets(t).numpy()
    lsb, rng = tnm.DEFAULT_MACRO.cal_lsb_v, tnm.DEFAULT_MACRO.cal_range_v
    inside = np.abs(raw) <= rng - 2 * lsb
    assert inside.sum() > 1000 and np.abs(res[inside]).max() <= 2 * lsb


# ---- the engine's noise context and epilogue -------------------------------

def _plans(spec, noise_kw=None):
    kw = noise_kw or {}
    jcfg = jrt.EngineConfig(noise=jnm.NoiseConfig(**kw))
    tcfg = trt.EngineConfig(noise=tnm.NoiseConfig(**kw))
    return (jrt.plan_layer(jmap.LayerSpec(**spec), jcfg), jcfg,
            trt.plan_layer(tmap.LayerSpec(**spec), tcfg), tcfg)


@pytest.mark.parametrize("spec", [
    dict(m=8, k=144, n=16, r_in=8, r_w=4, r_out=8),
    dict(m=8, k=72, n=16, r_in=2, r_w=1, r_out=6),
    dict(m=300, k=2304, n=80, r_in=4, r_w=2, r_out=8),
], ids=("small", "r2w1", "multi_tile"))
@pytest.mark.parametrize("identity", (False, True))
def test_layer_noise_context_matches_jax(spec, identity):
    """offset/droop codes, the gain multiplier and the whole thermal field
    (positional row blocks, or identity-keyed rows with a sub counter),
    float for float."""
    jl, jcfg, tl, tcfg = _plans(spec)
    m = spec["m"]
    gamma = np.random.default_rng(0).uniform(0.5, 20, tl.n_pad).astype(
        np.float32)
    ids = sub = None
    if identity:
        ids = (np.arange(m, dtype=np.int32) * 29 - 3) & 0x7FFFFFFF
        ids[0] = -1
        sub = np.arange(m, dtype=np.int32) % 7
    with jax.disable_jit():
        jn = jrt._layer_noise(
            jl, jcfg, _f32_leaves(jnm.NoiseConfig()), jnp.asarray(gamma),
            _jkey(11), m, row_ids=None if ids is None else jnp.asarray(ids),
            row_sub=None if sub is None else jnp.asarray(sub))
    tn = trt._layer_noise(
        tl, tcfg, tnm.leaves(tnm.NoiseConfig()), torch.from_numpy(gamma),
        prng.key_ints(prng.key(11)), m,
        row_ids=None if ids is None else torch.from_numpy(ids),
        row_sub=None if sub is None else torch.from_numpy(sub))
    for f in ("offset_codes", "droop_codes", "gain_mult", "thermal"):
        assert _same(getattr(jn, f), getattr(tn, f)), f
    assert tuple(tn.thermal.shape) == (len(tl.k_slices), len(tl.n_slices),
                                       m, tl.tile_n)


def test_noise_epilogue_matches_jax():
    """The ADC epilogue alone, on a thermal field drawn in JAX and passed
    in, so a draw fault and an epilogue fault cannot hide each other;
    per-column and per-row (segment) beta_eff."""
    spec = dict(m=4096, k=144, n=16, r_in=8, r_w=4, r_out=8)
    jl, jcfg, tl, tcfg = _plans(spec)
    g = np.random.default_rng(4)
    dp = g.integers(-60000, 60000, (4096, 16)).astype(np.int32)
    gamma = g.uniform(0.5, 30, 16).astype(np.float32)
    th = np.asarray(jax.random.normal(_jkey(1), (4096, 16))) * np.float32(3)
    ctx = dict(offset_codes=g.normal(0, 2, 16).astype(np.float32),
               droop_codes=g.uniform(0, 0.3, 16).astype(np.float32),
               gain_mult=np.float32(0.9987))
    for beta in (g.uniform(-4, 4, 16), g.uniform(-4, 4, (4096, 16))):
        beta = beta.astype(np.float32)
        with jax.disable_jit():
            jctx = jrt._LayerNoise(
                **{k: jnp.asarray(v) for k, v in ctx.items()},
                thermal=jnp.zeros((1, 1, 1, 16)))
            want = jrt._noise_adc_code(jl, jnp.asarray(dp),
                                       jnp.asarray(gamma), jnp.asarray(beta),
                                       jctx, (0, 16), jnp.asarray(th))
        tctx = trt._LayerNoise(
            **{k: torch.tensor(v) for k, v in ctx.items()},
            thermal=torch.zeros((1, 1, 1, 16)))
        got = trt._noise_adc_code(tl, torch.from_numpy(dp),
                                  torch.from_numpy(gamma),
                                  torch.from_numpy(beta), tctx, (0, 16),
                                  torch.from_numpy(th))
        assert got.dtype == torch.int32 and _same(want, got)


def test_jax_jit_rewrites_the_noise_chain():
    """ROADMAP Queue 3, a fault of the reference: under jit XLA rewrites
    the noise chain of `_layer_noise` (the SA-offset product sigma * z,
    70 of 256 offsets an ulp off, and the volts-to-codes products, folded
    and reassociated), so the jitted JAX engine's offset codes differ
    from its own source's rounded chain, which the port follows, by far
    less than a code.  Smallest input: one layer (m 8, k 144, n 16, r_in
    8, r_w 4), key 11."""
    jl, jcfg, _, _ = _plans(dict(m=8, k=144, n=16, r_in=8, r_w=4, r_out=8))
    gamma = np.random.default_rng(0).uniform(0.5, 20, 16).astype(np.float32)

    def codes(g, nz):
        ctx = jrt._layer_noise(jl, jcfg, nz, g, _jkey(11), 8)
        return ctx.offset_codes, ctx.droop_codes

    with jax.disable_jit():
        eager = codes(jnp.asarray(gamma), _f32_leaves(jnm.NoiseConfig()))
    jitted = jax.jit(codes)(jnp.asarray(gamma), jnm.NoiseConfig())
    assert not _same(eager[0], jitted[0])
    np.testing.assert_allclose(np.asarray(eager[0]), np.asarray(jitted[0]),
                               rtol=0, atol=1e-4)


# ---- whole engines ----------------------------------------------------------

def _programs(specs, noise_kw=None, acts=None, pools=None, **cfg_kw):
    kw = noise_kw or {}
    jp = jprog.compile_program(
        [jmap.LayerSpec(**s) for s in specs],
        jrt.EngineConfig(noise=jnm.NoiseConfig(**kw), **cfg_kw),
        activations=acts, pools=pools)
    tp = tprog.compile_program(
        [tmap.LayerSpec(**s) for s in specs],
        trt.EngineConfig(noise=tnm.NoiseConfig(**kw), **cfg_kw),
        activations=acts, pools=pools, device="cpu")
    return jp, tp


def _x(m, k, seed):
    return np.maximum(np.random.default_rng(seed).normal(size=(m, k)),
                      0).astype(np.float32)


def _jax_eager_reference(jbound, x, seed, noise=None):
    with jax.disable_jit():
        return np.asarray(jbound.reference(
            jnp.asarray(x), _jkey(seed),
            _f32_leaves(noise or jnm.NoiseConfig())))


@pytest.mark.parametrize("r_w", R_WS)
@pytest.mark.parametrize("r_in", R_INS)
def test_noisy_engine_grid_matches_jax(r_in, r_w):
    spec = dict(m=8, k=72, n=16, r_in=r_in, r_w=r_w, r_out=8)
    jp, tp = _programs([spec], acts=["none"])
    p = _seeded_params([(72, 16)], r_in * 10 + r_w)
    x = _x(8, 72, r_in)
    want = _jax_eager_reference(jp.bind(p), x, 3)
    tb = tp.bind(params_from_numpy(p))
    ref = tb.reference(torch.from_numpy(x), prng.key(3))
    assert _same(want, ref)
    assert torch.equal(tb.serve(torch.from_numpy(x), prng.key(3)), ref)


@pytest.mark.parametrize("spec", [
    dict(m=4, k=2304, n=80, r_in=8, r_w=4, r_out=8),
    dict(m=200, k=1300, n=200, r_in=4, r_w=2, r_out=6),
], ids=("k2304_n80", "k1300_n200"))
def test_noisy_multi_tile_layers_match_jax(spec):
    """K > 1152 (two row tiles) and several col tiles: per-tile keys,
    per-tile thermal slices and the partial-sum recombination."""
    jp, tp = _programs([spec], acts=["none"])
    p = _seeded_params([(spec["k"], spec["n"])], 5)
    x = _x(spec["m"], spec["k"], 6)
    assert tp.plan.layers[0].macro_evals > 2
    want = _jax_eager_reference(jp.bind(p), x, 9)
    tb = tp.bind(params_from_numpy(p))
    got = tb.serve(torch.from_numpy(x), prng.key(9))
    assert _same(want, got)
    assert torch.equal(tb.reference(torch.from_numpy(x), prng.key(9)), got)


def test_noisy_engine_matches_jitted_jax_on_random_inputs():
    """The jitted JAX reference (its own tests' contract) agrees with the
    port here: its rewrites move no code on these inputs."""
    specs = [dict(m=8, k=144, n=40, r_in=8, r_w=4, r_out=8),
             dict(m=8, k=40, n=10, r_in=8, r_w=4, r_out=8)]
    jp, tp = _programs(specs)
    p = _seeded_params([(144, 40), (40, 10)], 1)
    x = _x(8, 144, 2)
    want = np.asarray(jp.bind(p).reference(jnp.asarray(x), _jkey(4)))
    assert _same(want, tp.bind(params_from_numpy(p)).reference(
        torch.from_numpy(x), prng.key(4)))


def _lenet_pair(batch, seed=0, **cim_kw):
    from repro.core.cim_layers import CIMConfig as JCIM
    jcim = JCIM(mode="engine", r_in=4, r_w=2, noise=jnm.NoiseConfig(),
                **cim_kw)
    tcim = CIMConfig(mode="engine", r_in=4, r_w=2, noise=tnm.NoiseConfig(),
                     **cim_kw)
    jparams = jcnn.init_lenet(_jkey(seed), cim=jcim)
    np_params = {k: {f: np.asarray(v) for f, v in lay.items()}
                 for k, lay in jparams.items()}
    x = np.clip(np.random.default_rng(seed).normal(
        0.3, 0.4, (batch, 28, 28, 1)), 0, 1).astype(np.float32)
    return jcim, tcim, jparams, params_from_numpy(np_params), x


def test_noisy_lenet_forward_matches_jax():
    """LeNet in engine mode with noise at batch 2: lenet_forward(key=)
    equals JAX's (its program's bucketed serve, eager with float32
    leaves); the same key repeats, another key and the clean run
    differ."""
    jcim, tcim, jparams, tparams, x = _lenet_pair(2)
    jprog_ = jcnn.lenet_program(2, cim=jcim)
    with jax.disable_jit():
        want = np.asarray(jprog_.serve(
            jcnn.lenet_params_list(jparams), jnp.asarray(x), _jkey(1),
            _f32_leaves(jnm.NoiseConfig())))
    key = key_from_numpy(np.asarray(_jkey(1)))
    got = tcnn.lenet_forward(tparams, torch.from_numpy(x), tcim, key,
                             device="cpu")
    assert tuple(got.shape) == (2, 10) and _same(want, got)
    assert torch.equal(got, tcnn.lenet_forward(
        tparams, torch.from_numpy(x), tcim, key, device="cpu"))
    other = tcnn.lenet_forward(tparams, torch.from_numpy(x), tcim,
                               prng.key(2), device="cpu")
    clean = tcnn.lenet_forward(tparams, torch.from_numpy(x),
                               tcim.replace(noise=tnm.NO_NOISE),
                               device="cpu")
    assert not torch.equal(got, other) and not torch.equal(got, clean)


# ---- the port's own invariants under noise ----------------------------------

def _conv_program(stream_rows=0, **noise_kw):
    specs = [tmap.conv_layer_spec(4, 12, 12, 2, 8, padding=1, r_in=4,
                                  r_w=2),
             tmap.LayerSpec(m=4, k=8 * 6 * 6, n=7, r_in=4, r_w=2)]
    prog = tprog.compile_program(
        specs, trt.EngineConfig(noise=tnm.NoiseConfig(**noise_kw),
                                stream_rows=stream_rows),
        activations=["relu", "none"], pools=[2, 1], device="cpu")
    gen = torch.Generator().manual_seed(3)
    return prog, prog.bind(prog.init_params(gen))


def _images(b, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(b, 12, 12, 2)).astype(np.float32))


def test_noise_is_invariant_to_stream_chunks_and_bucket_padding():
    x = _images(3, 0)
    key = prng.key(5)
    prog, bound = _conv_program()
    want = prog.run(list(bound.program.init_params(
        torch.Generator().manual_seed(3))), x, key)
    assert torch.equal(bound.serve(x, key), want)       # bucket 4 vs exact 3
    for rows in (7, 100, 144):
        _, b2 = _conv_program(stream_rows=rows)
        assert torch.equal(b2.serve(x, key), want)
    # identity-keyed rows: the pad rows (copies of row 0) change nothing
    ids = tprog.request_noise_ids(2, 3)
    assert torch.equal(bound.serve(x, key, noise_ids=ids),
                       prog.run(list(prog.init_params(
                           torch.Generator().manual_seed(3))), x, key,
                           noise_ids=ids))


def test_identity_keyed_serve_batch_equals_solo():
    prog, bound = _conv_program()
    reqs = [_images(b, 10 + b) for b in (1, 4, 2)]
    key = prng.key(8)
    outs = bound.serve_batch(reqs, key, isolate=True)
    for i, (out, req) in enumerate(zip(outs, reqs)):
        solo = bound.serve(req, key, segments=torch.zeros(req.shape[0],
                                                          dtype=torch.int64),
                           noise_ids=tprog.request_noise_ids(
                               i, req.shape[0]))
        assert torch.equal(out, solo)
    # without isolation the fused batch is the concatenation's serve
    fused = bound.serve_batch(reqs, key)
    assert torch.equal(torch.cat(fused), bound.serve(torch.cat(reqs), key))
    assert not torch.equal(torch.cat(fused), torch.cat(outs))


def test_noise_needs_a_key_and_a_clean_plan_ignores_one():
    prog, bound = _conv_program()
    x = _images(2, 1)
    with pytest.raises(ValueError, match="requires a PRNG key"):
        bound.serve(x)
    with pytest.raises(ValueError, match="conflicts"):
        bound.serve(x, prng.key(0), tnm.NO_NOISE)
    clean = tprog.compile_program(
        [tmap.LayerSpec(m=4, k=20, n=6, r_in=4, r_w=2)], device="cpu")
    cb = clean.bind(clean.init_params(torch.Generator().manual_seed(0)))
    xs = torch.rand(3, 20)
    assert torch.equal(cb.serve(xs, prng.key(3)), cb.serve(xs))
    assert torch.equal(cb.serve(xs, prng.key(3)), cb.reference(xs))
    with pytest.raises(ValueError, match="conflicts"):
        cb.serve(xs, prng.key(3), tnm.NoiseConfig())
    # an override of the numbers draws under the same key
    loud = bound.serve(x, prng.key(0), tnm.NoiseConfig(thermal_rms_lsb8=4.0))
    assert not torch.equal(loud, bound.serve(x, prng.key(0)))


def test_dispatch_keys_count_noise_and_identity():
    tprog.clear_program_cache()
    prog, bound = _conv_program()
    before = prog.stats()["executables_compiled"]
    x = _images(2, 1)
    bound.serve(x, prng.key(0))
    bound.serve(x, prng.key(1))
    bound.serve(x, prng.key(0), noise_ids=tprog.request_noise_ids(0, 2))
    assert prog.stats()["executables_compiled"] == before + 2


def test_mc_thermal_std_matches_analytic():
    """Monte-Carlo thermal std in dequantized units tracks the analytic
    sigma (thermal_sigma_dp through the act/weight scales), with the
    static terms zeroed, as the JAX test of the same name."""
    spec = tmap.LayerSpec(m=64, k=144, n=16, r_in=8, r_w=4, r_out=8)
    prog = tprog.compile_program(
        [spec], trt.EngineConfig(noise=tnm.NoiseConfig(**THERMAL_ONLY)),
        activations=["none"], device="cpu")
    clean = tprog.compile_program([spec], activations=["none"],
                                  device="cpu")
    params = prog.init_params(torch.Generator().manual_seed(1))
    x = torch.relu(torch.randn(64, 144,
                               generator=torch.Generator().manual_seed(2)))
    y0 = clean.run(params, x)
    keys = prng.split(prng.key(2), 24)
    dev = torch.stack([prog.run(params, x, k) for k in keys]) - y0[None]
    from repro_torch.core.quantization import quantize_act, quantize_weight
    aq = quantize_act(x, 8)
    wq = quantize_weight(params[0]["w"], 4, axis=0)
    sigma_dp = tnm.thermal_sigma_dp(tnm.NoiseConfig(**THERMAL_ONLY), 8,
                                    prog.plan.layers[0].g0)
    want = sigma_dp * float(aq.scale) * wq.scale.reshape(-1)
    ratio = dev.std(dim=(0, 1)) / want
    assert abs(float(ratio.median()) - 1.0) < 0.12, ratio

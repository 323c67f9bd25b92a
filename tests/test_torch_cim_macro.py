"""The port's macro-side helpers against the JAX package: the voltage-domain
macro (`core/cim_macro.py`), the "sim" layer mode, `digital_ref`'s weight
snap and bit-plane dots, the ABN helpers and `quantize_act(scale=,
zero=)`.

Tolerances:

- bit for bit: `quantize_weight_odd`, `bitplane_dot`, `bitplane_dot_serial`,
  `quantize_act` with a given scale or zero (codes, and the gradient into
  the given scale and zero), the gamma quantizers, `quantize_beta_v` and
  `beta_v_to_codes` against jitted JAX, on grids that include the clip
  bounds; the macro's codes against JAX's, clean (eager, and jitted in one
  case) and noisy (eager, the same key);
- the sim layer's output within rtol 1e-5 plus 1e-6 of the largest of
  JAX's, clean and noisy: its codes are the macro's, and the zero-point
  term's column sums run in PyTorch's order;
- `fold_batchnorm`: within 4 ulp (rtol 5e-7) for gamma, and beta within
  rtol 1e-6 of the largest |beta|: jitted JAX turns scale / sqrt(.) into
  scale * rsqrt(.), and XLA's CPU rsqrt refines the host's estimate
  instead of rounding correctly;
- `distribution_aware_init`: log2 gamma within 1e-6 and beta within 1e-4
  of the largest |beta| (plus rtol 1e-5): the batch sums run in
  PyTorch's order, not XLA's;
- the macro within one code of the port's digital reference, and noise
  that perturbs the codes but stays within a few gamma-scaled LSBs
  (`tests/test_cim_macro.py`'s statements); sim within 0.1 relative of
  fakequant (`tests/test_cim_layers.py::test_sim_matches_fakequant_
  statistics`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abn as jabn
from repro.core import cim_layers as jcl
from repro.core import cim_macro as jm
from repro.core import digital_ref as jdr
from repro.core import quantization as jq
from repro.core.noise_model import NO_NOISE as J_NO_NOISE
from repro.core.noise_model import NoiseConfig as JNoise
from repro_torch.convert import key_from_numpy, params_from_numpy
from repro_torch.core import abn as tabn
from repro_torch.core import cim_layers as tcl
from repro_torch.core import cim_macro as tm
from repro_torch.core import digital_ref as tdr
from repro_torch.core import prng
from repro_torch.core import quantization as tq
from repro_torch.core.hw import DEFAULT_MACRO
from repro_torch.core.noise_model import NO_NOISE, NoiseConfig


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for this module, the previous count back after
    it: where pytest-xdist workers share the cores, PyTorch's pool spins
    at the barrier of each small CPU op (test_torch_sharding.py's note)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MACRO_CASES = [(8, 4, 8, 144, 1.0), (8, 4, 8, 1152, 4.0), (4, 2, 6, 300, 2.0),
               (1, 1, 1, 36, 1.0), (8, 1, 8, 72, 16.0), (2, 3, 5, 500, 8.0)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- digital_ref ------------------------------------------------------------

@pytest.mark.parametrize("r_w", (1, 2, 3, 4))
def test_quantize_weight_odd_matches_jax(r_w):
    full = 2 ** r_w - 1
    w = np.arange(-full - 3, full + 4, dtype=np.int32)
    want = np.asarray(jdr.quantize_weight_odd(jnp.asarray(w), r_w))
    got = tdr.quantize_weight_odd(_t(w), r_w)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r_in,r_w", [(1, 1), (4, 2), (8, 4), (3, 3)])
def test_bitplane_dots_match_jax(r_in, r_w):
    rng = np.random.default_rng(r_in * 10 + r_w)
    x = rng.integers(0, 2 ** r_in, size=(5, 7, 40)).astype(np.int32)
    x[0, 0] = 2 ** r_in - 1
    full = 2 ** r_w - 1
    w = (2 * rng.integers(-(full + 1) // 2, (full + 1) // 2, size=(40, 9))
         + 1).astype(np.int32)
    w[:, 0] = full
    planes = np.asarray(jdr.encode_weight_planes(jnp.asarray(w), r_w))
    want = np.asarray(jdr.bitplane_dot(jnp.asarray(x), jnp.asarray(planes)))
    want_s = np.asarray(jdr.bitplane_dot_serial(jnp.asarray(x),
                                                jnp.asarray(planes), r_in))
    got = tdr.bitplane_dot(_t(x), _t(planes))
    got_s = tdr.bitplane_dot_serial(_t(x), _t(planes), r_in)
    assert got.dtype == got_s.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(want, want_s)


# ---- quantize_act with a given scale / zero ---------------------------------

@pytest.mark.parametrize("given", ("scale", "zero", "both"))
@pytest.mark.parametrize("segments", (False, True))
def test_quantize_act_given_scale_zero_matches_jax(given, segments):
    """The given operand is used as it is and takes the gradient; the
    other stays dynamic (and stop-gradiented), per segment if asked.  The
    inputs put codes on both clip bounds."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 2, size=(4, 3, 16)).astype(np.float32)
    x[0, 0, :2] = -9.0              # below the given zero: code 0
    x[3, 2, -2:] = 200.0            # above the given range: top code
    scale = np.float32(0.37)
    zero = np.float32(-1.25)
    seg = np.array([0, 1, 1, 2], np.int32)
    kw_j = {}
    kw_t = {}
    if segments:
        kw_j = dict(segment_ids=jnp.asarray(seg), num_segments=3)
        kw_t = dict(segment_ids=_t(seg), num_segments=3)
    gq = rng.normal(size=x.shape).astype(np.float32)
    for r_in in (1, 4, 8):
        def jfn(x_, s_, z_):
            aq = jq.quantize_act(
                x_, r_in, scale=s_ if given != "zero" else None,
                zero=z_ if given != "scale" else None, **kw_j)
            return jnp.sum(aq.q * gq) + jnp.sum(aq.scale) + jnp.sum(aq.zero)
        jaq = jax.jit(lambda x_, s_, z_: jq.quantize_act(
            x_, r_in, scale=s_ if given != "zero" else None,
            zero=z_ if given != "scale" else None, **kw_j))(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(zero))
        jg = jax.jit(jax.grad(jfn, argnums=(0, 1, 2)))(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(zero))
        tx = _t(x).requires_grad_(True)
        ts = torch.tensor(scale).requires_grad_(True)
        tz = torch.tensor(zero).requires_grad_(True)
        taq = tq.quantize_act(tx, r_in, scale=ts if given != "zero" else None,
                              zero=tz if given != "scale" else None, **kw_t)
        for name in ("q", "scale", "zero"):
            w_, g_ = np.asarray(getattr(jaq, name)), getattr(taq, name)
            assert g_.shape == w_.shape, name
            np.testing.assert_array_equal(_bits(g_.detach().numpy()),
                                          _bits(w_))
        q = taq.q.detach().numpy()
        assert q.min() == 0 and q.max() == 2 ** r_in - 1
        (torch.sum(taq.q * _t(gq)) + torch.sum(taq.scale)
         + torch.sum(taq.zero)).backward()
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[0]),
                                   rtol=1e-6, atol=1e-6)
        for t_, j_, used in ((ts, jg[1], given != "zero"),
                             (tz, jg[2], given != "scale")):
            if used:
                np.testing.assert_allclose(float(t_.grad), float(j_),
                                           rtol=1e-5)
            else:
                assert t_.grad is None and float(j_) == 0.0


def test_quantize_act_default_path_unchanged():
    """With neither given, the dynamic swing stays a constant to the
    gradient (equal to the call without the new keywords)."""
    x = _t(np.random.default_rng(0).normal(size=(3, 20)).astype(np.float32))
    a = tq.quantize_act(x, 4)
    b = tq.quantize_act(x, 4, scale=None, zero=None)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not a.scale.requires_grad and not a.zero.requires_grad


# ---- ABN helpers ------------------------------------------------------------

def _gamma_grid():
    lo, hi = np.float32(0.5), np.float32(40.0)
    g = np.arange(lo.view(np.int32), hi.view(np.int32), 997,
                  dtype=np.int32).view(np.float32)
    # the clip bounds, the level boundaries' neighbourhoods
    edges = [1.0, 32.0, 2.0 ** 16, 0.0625, 2 ** 0.5, 2 ** 2.5]
    near = [np.nextafter(np.float32(e), np.float32(s))
            for e in edges for s in (-np.inf, np.inf)]
    return np.concatenate([g, np.float32(edges), np.float32(near)])


def test_gamma_pow2_matches_jax_on_a_dense_grid():
    g = _gamma_grid()
    want = np.asarray(jax.jit(jabn.quantize_gamma_pow2)(g))
    got = tabn.quantize_gamma_pow2(_t(g))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    for kw in (dict(max_gamma=16.0), dict(min_gamma=2.0, max_gamma=8.0)):
        want = np.asarray(jax.jit(lambda x: jabn.quantize_gamma_pow2(
            x, **kw))(g))
        got = tabn.quantize_gamma_pow2(_t(g), **kw)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("bits", (0, 1, 2, 3, 4, 5))
def test_gamma_bits_matches_jitted_jax_on_a_dense_grid(bits):
    """The level index rounds log2(g) / step with XLA's log and the two
    constant divides folded into one multiply: torch.log2 and a divide
    move the index at a few grid points near a level boundary."""
    g = _gamma_grid()
    for mg in (32.0, 16.0, 8.0):
        want = np.asarray(jax.jit(lambda x: jabn.quantize_gamma_bits(
            x, bits, max_gamma=mg))(g))
        got = tabn.quantize_gamma_bits(_t(g), bits, max_gamma=mg)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_gamma_quantizer_gradients_match_jax():
    """STE through the clip: 1 inside, 1/2 on a bound, 0 outside."""
    g = np.float32([0.5, 1.0, 3.3, 32.0, 40.0, 5.9])
    gy = np.float32([1, 2, 3, 4, 5, 6])
    for jf, tf in ((jabn.quantize_gamma_pow2, tabn.quantize_gamma_pow2),
                   (lambda x: jabn.quantize_gamma_bits(x, 3),
                    lambda x: tabn.quantize_gamma_bits(x, 3))):
        want = np.asarray(jax.grad(lambda x: jnp.sum(jf(x) * gy))(
            jnp.asarray(g)))
        t = _t(g).requires_grad_(True)
        torch.sum(tf(t) * _t(gy)).backward()
        np.testing.assert_array_equal(t.grad.numpy(), want)
        np.testing.assert_array_equal(want[:4], [0, 1, 3, 2])


def test_beta_quantizers_match_jax():
    b = np.concatenate([np.linspace(-0.04, 0.04, 40001, dtype=np.float32),
                        np.float32([-0.03, 0.03, 0.0])])
    want = np.asarray(jax.jit(jabn.quantize_beta_v)(b))
    got = tabn.quantize_beta_v(_t(b))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # round half to even puts the bound itself one step out (JAX's too)
    lsb = 2 * DEFAULT_MACRO.abn_offset_range_v / 31
    assert float(np.abs(want).max()) <= \
        DEFAULT_MACRO.abn_offset_range_v + lsb
    gamma = np.random.default_rng(1).uniform(0.5, 40, b.size) \
        .astype(np.float32)
    for r_out in (1, 4, 8):
        want = np.asarray(jax.jit(lambda x, y: jabn.beta_v_to_codes(
            x, y, r_out))(b, gamma))
        got = tabn.beta_v_to_codes(_t(b), _t(gamma), r_out)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # the STE gradient: 1 inside the range, 1/2 on a bound, 0 outside
    bb = np.float32([-0.05, -0.03, 0.001, 0.03, 0.05])
    want = np.asarray(jax.grad(lambda x: jnp.sum(jabn.quantize_beta_v(x)))(
        jnp.asarray(bb)))
    t = _t(bb).requires_grad_(True)
    torch.sum(tabn.quantize_beta_v(t)).backward()
    np.testing.assert_array_equal(t.grad.numpy(), want)


def test_init_abn_and_fold_batchnorm_match_jax():
    p = tabn.init_abn(5)
    jp = jabn.init_abn(5)
    for a, b in zip(p, jp):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rng = np.random.default_rng(0)
    n = 20000
    sc, bi, mu = (rng.standard_normal(n).astype(np.float32) for _ in range(3))
    var = rng.uniform(0, 3, n).astype(np.float32)
    var[:10] = 0.0
    jg, jb = jax.jit(jabn.fold_batchnorm)(sc, bi, mu, var)
    tg, tb = tabn.fold_batchnorm(_t(sc), _t(bi), _t(mu), _t(var))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=5e-7, atol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                               atol=1e-6 * float(np.abs(jb).max()))
    # the JAX test's statement: gamma*y + beta == BN(y)
    y = rng.standard_normal(n).astype(np.float32)
    bn = sc * (y - mu) / np.sqrt(var + 1e-5) + bi
    np.testing.assert_allclose((tg * _t(y) + tb).numpy(), bn, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("batch", (1, 7, 64, 256))
def test_distribution_aware_init_matches_jax(batch):
    rng = np.random.default_rng(batch)
    dp = (rng.standard_normal((batch, 48)) * rng.uniform(0.01, 300, 48)
          + rng.uniform(-100, 100, 48)).astype(np.float32)
    for r_out in (4, 8):
        want = jax.jit(lambda d: jabn.distribution_aware_init(d, r_out))(dp)
        got = tabn.distribution_aware_init(_t(dp), r_out)
        np.testing.assert_allclose(got.log_gamma.numpy(),
                                   np.asarray(want.log_gamma), rtol=0,
                                   atol=1e-6)
        wb = np.asarray(want.beta)
        np.testing.assert_allclose(got.beta.numpy(), wb, rtol=1e-5,
                                   atol=1e-4 * float(np.abs(wb).max()))
        lg = got.log_gamma.numpy()
        assert lg.min() >= 0.0 and lg.max() <= 5.0     # gamma in [1, 32]


# ---- the voltage-domain macro -----------------------------------------------

def _macro_case(r_in, r_w, r_out, k, gamma):
    key = jax.random.PRNGKey(k + r_in)
    x = jax.random.randint(key, (6, k), 0, 2 ** r_in).astype(jnp.int32)
    w = jdr.quantize_weight_odd(
        jax.random.randint(jax.random.PRNGKey(1), (k, 8),
                           -(2 ** r_w - 1), 2 ** r_w), r_w)
    planes = jdr.encode_weight_planes(w, r_w)
    beta_codes = jnp.arange(8, dtype=jnp.float32) - 4.0
    lsb_v = DEFAULT_MACRO.alpha_adc() * DEFAULT_MACRO.vddh / 2 ** (r_out - 1)
    return x, planes, beta_codes, beta_codes * lsb_v / gamma


@pytest.mark.parametrize("r_in,r_w,r_out,k,gamma", MACRO_CASES)
def test_macro_matches_jax_and_digital_ref(r_in, r_w, r_out, k, gamma):
    x, planes, beta_codes, beta_v = _macro_case(r_in, r_w, r_out, k, gamma)
    kw = dict(r_in=r_in, r_out=r_out, gamma=gamma)
    want = np.asarray(jm.cim_macro_forward(x, planes, beta_v=beta_v,
                                           noise=J_NO_NOISE, **kw))
    tx, tp = _t(np.asarray(x)), _t(np.asarray(planes))
    got = tm.cim_macro_forward(tx, tp, beta_v=_t(np.asarray(beta_v)),
                               noise=NO_NOISE, **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if k == 144:        # and jitted (one case: the unrolled loops compile
        # slowly)
        want_jit = np.asarray(jax.jit(lambda a, b, c: jm.cim_macro_forward(
            a, b, beta_v=c, noise=J_NO_NOISE, **kw))(x, planes, beta_v))
        np.testing.assert_array_equal(got.numpy(), want_jit)
    ref = tdr.cim_matmul_ref(tx, tp, r_in=r_in, r_out=r_out, gamma=gamma,
                             beta_codes=_t(np.asarray(beta_codes)))
    assert int((ref - got).abs().max()) <= 1


def test_macro_noise_matches_jax_and_stays_bounded():
    k = 288
    key = jax.random.PRNGKey(0)
    x = jax.random.randint(key, (8, k), 0, 256).astype(jnp.int32)
    w = jdr.quantize_weight_odd(
        jax.random.randint(jax.random.PRNGKey(1), (k, 16), -15, 16), 4)
    planes = jdr.encode_weight_planes(w, 4)
    tx, tp = _t(np.asarray(x)), _t(np.asarray(planes))
    for seed in (7,):
        with jax.disable_jit():
            want = np.asarray(jm.cim_macro_forward(
                x, planes, r_in=8, r_out=8, gamma=8.0, noise=JNoise(),
                key=jax.random.PRNGKey(seed)))
        got = tm.cim_macro_forward(
            tx, tp, r_in=8, r_out=8, gamma=8.0, noise=NoiseConfig(),
            key=key_from_numpy(np.asarray(jax.random.PRNGKey(seed))))
        np.testing.assert_array_equal(got.numpy(), want)
    clean = tm.cim_macro_forward(tx, tp, r_in=8, r_out=8, gamma=8.0,
                                 noise=NO_NOISE)
    diff = (clean.long() - got.long()).abs().numpy()
    assert diff.max() > 0
    assert np.mean(diff) < 24
    # a given SA offset replaces the sampled one; no key, no draws
    again = tm.cim_macro_forward(tx, tp, r_in=8, r_out=8, gamma=8.0,
                                 noise=NoiseConfig(),
                                 sa_offset_v=torch.zeros(16))
    with jax.disable_jit():
        want = np.asarray(jm.cim_macro_forward(
            x, planes, r_in=8, r_out=8, gamma=8.0, noise=JNoise(),
            sa_offset_v=jnp.zeros(16)))
    np.testing.assert_array_equal(again.numpy(), want)


def test_macro_stages_match_jax():
    """The stages alone, at their float inputs: accumulation with and
    without noise, the weight combine, the ADC with per-channel gamma."""
    rng = np.random.default_rng(3)
    dev = rng.normal(0, 0.01, size=(4, 5, 6)).astype(np.float32)
    for noise_j, noise_t in ((J_NO_NOISE, NO_NOISE),
                             (JNoise(), NoiseConfig())):
        want = np.asarray(jm.mbiw_input_accumulate(
            jnp.asarray(dev), r_in=4, noise=noise_j, cfg=DEFAULT_MACRO))
        got = tm.mbiw_input_accumulate(_t(dev), r_in=4, noise=noise_t,
                                       cfg=DEFAULT_MACRO)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    for r_w in (1, 2, 4):
        want = np.asarray(jm.mbiw_weight_combine(jnp.asarray(dev[:r_w]), r_w))
        got = tm.mbiw_weight_combine(_t(dev[:r_w]), r_w)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    gamma = rng.uniform(1, 32, 6).astype(np.float32)
    beta = rng.uniform(-0.02, 0.02, 6).astype(np.float32)
    sa = rng.normal(0, 1e-3, 6).astype(np.float32)
    want = np.asarray(jm.dsci_adc(
        jnp.asarray(dev[0]), r_out=6, gamma=jnp.asarray(gamma),
        beta_v=jnp.asarray(beta), sa_offset_v=jnp.asarray(sa),
        cfg=DEFAULT_MACRO))
    got = tm.dsci_adc(_t(dev[0]), r_out=6, gamma=_t(gamma), beta_v=_t(beta),
                      sa_offset_v=_t(sa), cfg=DEFAULT_MACRO)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- the sim layer mode -----------------------------------------------------

def _sim_layer(k, n, seed):
    cfg = jcl.CIMConfig(mode="fakequant")
    p = jcl.init_cim_linear(jax.random.PRNGKey(seed), k, n, cfg=cfg)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (8, k))
    return p, x


@pytest.mark.parametrize("k,n,r_in,r_w,full", [(144, 8, 8, 4, True),
                                               (1300, 20, 4, 2, False),
                                               (9, 16, 2, 1, False)])
def test_sim_layer_matches_jax(k, n, r_in, r_w, full):
    """The sim layer against JAX's eager one (and, in the JAX test's case,
    its jitted one and a noisy run under one key): the macro codes are
    equal (the macro tests above), and the dequantized outputs within rtol
    1e-5 plus 1e-6 of the largest, since the zero-point term's column sums
    run in PyTorch's order, not XLA's; and the JAX test's statement in its
    case: sim within 0.1 relative of fakequant."""
    p, x = _sim_layer(k, n, k)
    jc = jcl.CIMConfig(mode="sim", r_in=r_in, r_w=r_w)
    tc = tcl.CIMConfig(mode="sim", r_in=r_in, r_w=r_w)
    tp = params_from_numpy({"l": {kk: np.asarray(v)
                                  for kk, v in p.items()}})["l"]
    tx = _t(np.asarray(x))
    got = tcl.cim_linear_apply(tp, tx, tc)
    wants = [np.asarray(jcl.cim_linear_apply(p, x, jc))]
    if full:
        wants.append(np.asarray(jax.jit(lambda a, b: jcl.cim_linear_apply(
            a, b, jc))(p, x)))
    for w_ in wants:
        np.testing.assert_allclose(got.numpy(), w_, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w_).max()))
    if not full:
        return
    yf = tcl.cim_linear_apply(tp, tx, tc.replace(mode="fakequant"))
    assert float(torch.linalg.norm(yf - got) / torch.linalg.norm(yf)) < 0.1
    with jax.disable_jit():
        want_n = np.asarray(jcl.cim_linear_apply(
            p, x, jc.replace(noise=JNoise()), key=jax.random.PRNGKey(5)))
    got_n = tcl.cim_linear_apply(tp, tx, tc.replace(noise=NoiseConfig()),
                                 key=prng.key(5))
    np.testing.assert_allclose(got_n.numpy(), want_n, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want_n).max()))
    assert not torch.equal(got_n, got)


def test_sim_layer_is_inference_only():
    p, x = _sim_layer(144, 8, 0)
    tp = {k: _t(np.asarray(v)).requires_grad_(True) for k, v in p.items()}
    tx = _t(np.asarray(x)).requires_grad_(True)
    y = tcl.cim_linear_apply(tp, tx, tcl.CIMConfig(mode="sim"))
    assert not y.requires_grad
    # a three-dimensional batch keeps its leading axes and dtype
    y3 = tcl.cim_linear_apply(tp, tx.detach().reshape(2, 4, 144).double(),
                              tcl.CIMConfig(mode="sim"))
    assert y3.shape == (2, 4, 8) and y3.dtype == torch.float64

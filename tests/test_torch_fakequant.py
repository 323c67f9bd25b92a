"""The port's CIM-aware training layer against the JAX package:
`cim_linear_apply` in modes bypass and fakequant, the STE quantizers, the
ADC floor and the differentiable, device-side `exp2_f32`.

Forward: fakequant equals jitted JAX bit for bit (integer codes, the same
float chain in the same order).  Bypass is one float matmul whose
summation order is each library's own: within rtol = atol = 1e-5 in
float32 and 1e-2 in bfloat16.  Gradients: within rtol 1e-4 plus 1e-5 of
the largest gradient of the tensor, since the backward sums the
straight-through products in another order and differentiates the
dequantizing divide as -g*x/(y*y) where JAX forms -g*x*y^-2.  Every clip
must give JAX's gradient of 1/2 at a bound, and the inputs are built to
sit on those bounds.
"""
from decimal import Decimal, localcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cim_layers as jcl
from repro.core import quantization as jq
from repro_torch.core import abn as tabn
from repro_torch.core import cim_layers as tcl
from repro_torch.core import quantization as tq


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _bits_equal(a, b):
    a = np.asarray(a, np.float32)
    b = b.detach().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(a.view(np.uint32), b.astype(np.float32)
                          .view(np.uint32)), \
        f"{np.sum(a.view(np.uint32) != b.view(np.uint32))} elements differ"


def _close_grad(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * max(np.abs(want).max(), 1e-30))


def _layer_case(k, n, r_w, seed):
    """Inputs on the clip bounds: the tensor's minimum repeated (codes at
    0), weight columns whose amax is full * 2^-3 and repeated (w / scale
    exactly +/-full), and gains large enough to saturate the ADC."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 5, k)).astype(np.float32)
    x[0, 0, :3] = x.min()
    x[2, 4, -2:] = x.max()
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    full = 2.0 ** r_w - 1.0
    for c in range(0, n, 3):
        w[:, c] = np.clip(w[:, c], -full / 8, full / 8)
        w[c % k, c] = full / 8
        w[(c + 1) % k, c] = -full / 8
    lg = rng.uniform(0, 9, n).astype(np.float32)
    beta = rng.uniform(-3, 3, n).astype(np.float32)
    return x, {"w": w, "abn_log_gamma": lg, "abn_beta": beta}


def _fakequant_layer(r_in, r_w, k, dtype):
    """One fakequant layer on `_layer_case` inputs, the activation in
    `dtype` and the parameters float32 as the model holds them: the
    forward bit for bit against jitted JAX, the gradients within
    `_close_grad`; a bfloat16 input gradient also within one bfloat16 ulp
    (2^-7 relative), as the two round the same float32 sum."""
    x, p = _layer_case(k, 48, r_w, k + 10 * r_in)
    jc = jcl.CIMConfig(mode="fakequant", r_in=r_in, r_w=r_w,
                       max_gamma=2.0**16)
    tc = tcl.CIMConfig(mode="fakequant", r_in=r_in, r_w=r_w,
                       max_gamma=2.0**16)
    gy = np.random.default_rng(k).standard_normal((3, 5, 48)) \
        .astype(np.float32)
    jp = {kk: jnp.asarray(v) for kk, v in p.items()}
    jx = jnp.asarray(x).astype(dtype)
    jy = jax.jit(lambda p_, x_: jcl.cim_linear_apply(p_, x_, jc))(jp, jx)
    jgp, jgx = jax.jit(jax.grad(
        lambda p_, x_: jnp.sum(jcl.cim_linear_apply(p_, x_, jc)
                               .astype(jnp.float32) * gy),
        argnums=(0, 1)))(jp, jx)
    tp = {kk: _t(v, grad=True) for kk, v in p.items()}
    tx = _t(x).to(getattr(torch, dtype)).requires_grad_()
    ty = tcl.cim_linear_apply(tp, tx, tc)
    assert ty.dtype == tx.dtype
    _bits_equal(jy.astype(jnp.float32), ty.float())
    (ty.float() * _t(gy)).sum().backward()
    if dtype == "float32":
        _close_grad(tx.grad, jgx)
    else:
        want = np.asarray(jgx.astype(jnp.float32))
        np.testing.assert_allclose(
            tx.grad.float().numpy(), want, rtol=2.0**-7,
            atol=1e-5 * np.abs(want).max())
    for name in p:
        _close_grad(tp[name].grad, jgp[name])


@pytest.mark.parametrize("k", (64, 1152, 2500))
@pytest.mark.parametrize("r_in,r_w", [(8, 4), (4, 2), (1, 1)])
def test_fakequant_forward_bit_exact_and_grads(r_in, r_w, k):
    _fakequant_layer(r_in, r_w, k, "float32")


@pytest.mark.parametrize("k", (64, 1152, 2500))
@pytest.mark.parametrize("r_in,r_w", [(8, 4), (4, 2), (1, 1)])
def test_fakequant_bf16_forward_bit_exact_and_grads(r_in, r_w, k):
    """A bfloat16 activation, as the model feeds every projection: the
    codes agree with JAX's, so the ABN gradients (the codes' quantization
    residuals) are held as tightly as in float32."""
    _fakequant_layer(r_in, r_w, k, "bfloat16")


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("k", (64, 1152, 2500))
def test_bypass_forward_and_grads(k, dtype):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((3, 5, k)).astype(np.float32)
    w = (rng.standard_normal((k, 24)) / np.sqrt(k)).astype(np.float32)
    cfg = jcl.CIMConfig(mode="bypass")
    jy = jax.jit(lambda w_, x_: jcl.cim_linear_apply({"w": w_}, x_, cfg))(
        jnp.asarray(w), jnp.asarray(x).astype(dtype))
    tw = _t(w, grad=True)
    ty = tcl.cim_linear_apply({"w": tw}, _t(x).to(getattr(torch, dtype)),
                              tcl.CIMConfig(mode="bypass"))
    assert ty.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(jy, np.float32), rtol=tol, atol=tol)
    if dtype == "float32":
        jg = jax.grad(lambda w_: jnp.sum(jcl.cim_linear_apply(
            {"w": w_}, jnp.asarray(x), cfg) ** 2))(jnp.asarray(w))
        (ty ** 2).sum().backward()
        _close_grad(tw.grad, jg)


def test_clip_gradient_is_half_at_a_bound():
    """jnp.clip's gradient at [lo, mid, hi] is [0.5, 1, 0.5]; the port's
    _clip gives the same (torch.clamp would give 1)."""
    x = torch.tensor([0.0, 0.5, 1.0], requires_grad=True)
    tq._clip(x, 0.0, 1.0).sum().backward()
    want = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(
        jnp.asarray([0.0, 0.5, 1.0]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(x.grad.numpy(), [0.5, 1.0, 0.5])


@pytest.mark.parametrize("fn", ("ste_round", "ste_floor"))
def test_ste_forward_and_gradient(fn):
    v = np.random.default_rng(2).uniform(-300, 300, 4096).astype(np.float32)
    v[:8] = [0.5, 1.5, -0.5, 2.5, 0.0, -0.0, 255.0, 254.99998]
    tv = _t(v, grad=True)
    out = getattr(tq, fn)(tv)
    _bits_equal(getattr(jq, fn)(jnp.asarray(v)), out)
    out.sum().backward()
    np.testing.assert_array_equal(tv.grad.numpy(), np.ones_like(v))


@pytest.mark.parametrize("r_out", (1, 4, 8))
def test_adc_quantize_matches_jax(r_out):
    rng = np.random.default_rng(r_out)
    dp = rng.integers(-4000, 4000, size=(64, 16)).astype(np.float32)
    gain = (2.0 ** rng.uniform(-6, 0, 16)).astype(np.float32)
    beta = rng.uniform(-8, 8, (64, 16)).astype(np.float32)
    dp[0] = (2.0 ** r_out - 1) / 1  # codes landing on the bounds
    gain[0] = 1.0
    beta[0, 0] = -(2.0 ** (r_out - 1)) + 0.25

    def jfn(dp_, g_, b_):
        return jq.adc_quantize(dp_, r_out=r_out, gain=g_, beta_codes=b_)
    cot = rng.standard_normal((64, 16)).astype(np.float32)
    jy = jfn(*map(jnp.asarray, (dp, gain, beta)))
    jg = jax.grad(lambda *a: jnp.sum(jfn(*a) * cot), argnums=(0, 1, 2))(
        *map(jnp.asarray, (dp, gain, beta)))
    ts = [_t(a, grad=True) for a in (dp, gain, beta)]
    ty = tq.adc_quantize(ts[0], r_out=r_out, gain=ts[1], beta_codes=ts[2])
    _bits_equal(jy, ty)
    (ty * _t(cot)).sum().backward()
    for t, j in zip(ts, jg):
        _close_grad(t.grad, j)


def _exp2_numpy(xs: np.ndarray) -> np.ndarray:
    """The host (numpy) form of C's exp2f that the device version
    replaced: the reference it is held to bit for bit."""
    tab = []
    with localcontext() as ctx:
        ctx.prec = 60
        for i in range(32):
            v = np.float64(float(Decimal(2) ** (Decimal(i) / Decimal(32))))
            tab.append(int(v.view(np.uint64)) - (i << 52) // 32)
    tab = np.array(tab, np.uint64)
    shift = float.fromhex("0x1.8p+52") / 32
    c0, c1, c2 = (float.fromhex("0x1.c6af84b912394p-5"),
                  float.fromhex("0x1.ebfce50fac4f3p-3"),
                  float.fromhex("0x1.62e42ff0c52d6p-1"))
    with np.errstate(invalid="ignore", over="ignore"):
        xd = xs.astype(np.float64)
        kd = xd + shift
        ki = kd.view(np.uint64)
        r = xd - (kd - shift)
        s = (tab[ki % np.uint64(32)] + (ki << np.uint64(47))).view(np.float64)
        out = (((c0 * r + c1) * (r * r) + (c2 * r + 1.0)) * s) \
            .astype(np.float32)
    out = np.where(xs >= 128.0, np.float32(np.inf), out)
    out = np.where((out < np.float32(2.0 ** -126)) | (xs <= -150.0),
                   np.float32(0.0), out)
    return np.where(np.isnan(xs), xs, out)


def test_exp2_device_form_equals_host_form():
    """On the points of test_torch_core.py::test_exp2_matches_xla_pow, plus
    NaN and subnormal-result inputs."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.uniform(-8, 8, 50000),
                        rng.uniform(-160, 140, 20000),
                        [0.0, -0.0, 127.99, 128.0, -150.0, -149.5,
                         np.inf, -np.inf, np.nan, -127.5, -126.0,
                         1e30, -1e30]]).astype(np.float32)
    got = tabn.exp2_f32(_t(x)).numpy()
    want = _exp2_numpy(x)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_abn_gamma_gradient_matches_jax():
    """d gamma / d log_gamma is JAX's pow jvp g * (log(2) * y), halved
    where the clip to [2^-4, max_gamma] is at a bound."""
    from repro.core import abn as jabn
    lg = np.concatenate([np.random.default_rng(3).uniform(-6, 7, 2000),
                         [0.0594, 5.0, -4.0]]).astype(np.float32)
    beta = np.zeros_like(lg)
    for bits in (-1, 3):
        jg = jax.grad(lambda a: jnp.sum(jabn.abn_gamma(
            jabn.ABNParams(a, jnp.asarray(beta)), gamma_bits=bits,
            max_gamma=32.0)))(jnp.asarray(lg))
        t = _t(lg, grad=True)
        tabn.abn_gamma(tabn.ABNParams(t, _t(beta)), gamma_bits=bits,
                       max_gamma=32.0).sum().backward()
        _bits_equal(jg, t.grad)
        if bits < 0:
            np.testing.assert_allclose(t.grad[-3:].numpy(),
                                       [0.7222818, 11.090355, 0.02166085],
                                       rtol=1e-6)


def test_noise_and_other_modes_raise():
    p = {"w": torch.zeros((4, 2)), "abn_log_gamma": torch.zeros(2),
         "abn_beta": torch.zeros(2)}
    x = torch.ones((1, 4))
    # the engine and deploy modes are ported (tests/test_torch_serve.py),
    # sim (tests/test_torch_cim_macro.py) and the sharded engine layer
    # (tests/test_torch_sharding.py), which takes a runtime ShardingConfig
    # only
    assert tcl.cim_linear_apply(p, x, tcl.CIMConfig(mode="sim")).shape \
        == (1, 2)
    with pytest.raises(TypeError, match="ShardingConfig"):
        tcl.cim_linear_apply(p, x, tcl.CIMConfig(mode="engine",
                                                 sharding=object()))
    with pytest.raises(ValueError):
        tcl.cim_linear_apply(p, x, tcl.CIMConfig(mode="nope"))

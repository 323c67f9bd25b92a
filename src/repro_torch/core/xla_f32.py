"""XLA's float32 `log1p`, `erf_inv`, `exp` and `log2`, rounded as XLA's CPU
backend rounds them.

The JAX package draws its noise with `jax.random.normal`, which is
`sqrt(2) * erf_inv(u)` over a uniform `u`, and settles the DPL with
`jnp.exp`.  XLA expands these into its own float32 polynomials (a Cephes
`log(1 + x)` with a rational `log1p` for small arguments, Giles' two
`erf_inv` polynomials split at w = 5, a Cephes `exp`); PyTorch's `log1p`
and `exp` differ from them by an ulp on 8.5% and 9.7% of float32 inputs,
and one ulp of a normal draw can move an ADC code.

Each routine here is the code XLA's CPU backend runs, operation for
operation.  The LLVM IR that XLA emits shows plain `fmul`/`fadd`, but
LLVM contracts a multiply feeding a single add into one fused
multiply-add when it selects instructions, so the machine code (and the
floats) has `vfmadd` where the IR has a single-use product: every such
step here is `fma_f32`, every other one a rounded `*`, `+` or `-` by a
float32 constant, with one tensor-by-tensor `/`, `torch.where`, `floor`,
a correctly rounded `sqrt` and int32 views.  XLA also flushes subnormals
to zero (`ftz`).  Each step is exact on the CPU and on CUDA, so the
result is the same float32 on both; the CUDA draw kernel
(`kernels/prng/csrc/threefry_normal.cu`) repeats the steps with
`__fmaf_rn`, `__fmul_rn`, `__fadd_rn` and `__fsqrt_rn`.

To read the code again (for another JAX version): run a jitted
`jax.random.normal`, `jnp.log1p` and `jnp.exp` on the CPU with
`XLA_FLAGS=--xla_dump_to=DIR`; the operations and constants are in
`DIR/*broadcast_multiply_fusion_kernel_module.ir-with-opt.ll` (normal:
uniform, log1p, erf_inv) and `DIR/*wrapped_exponential*ir-with-opt.ll`,
and which of them fuse is in the disassembly of the matching
`DIR/*obj-file*.o` (`objdump -d`).  The constants are the IR's hex
doubles, each an exact float32.
"""
from __future__ import annotations

import struct
from typing import Optional

import numpy as np
import torch

from repro_torch.core.quantization import lint_opaque


def _h(hexdouble: str) -> float:
    """The float an LLVM IR hex double constant names (an exact float32)."""
    return struct.unpack(">d", bytes.fromhex(hexdouble))[0]


F32_MIN_NORMAL = _h("3810000000000000")       # 2^-126
SQRT_HALF = _h("3FE6A09E60000000")            # f32(sqrt(0.5))
LOG1P_SMALL = _h("3FDA8279A0000000")          # f32(sqrt(2) - 1)
LN2_HI = _h("3FE6300000000000")               # 0.693359375
LN2_LO = _h("BF2BD01060000000")               # -2.12194440e-4
LOG2E = _h("3FF7154760000000")
SQRT2 = _h("3FF6A09E60000000")                # f32(sqrt(2))
EXP_LO = _h("C055F33340000000")               # -87.8
EXP_HI = _h("4056333340000000")               # 88.8

# log(1 + x) for x >= sqrt(2) - 1: the three interleaved Horner chains
_LOG_C = [_h(c) for c in (
    "3FB2043760000000", "BFBD7A3700000000", "BFBFCBA9E0000000",
    "3FC23D37E0000000", "3FC999D580000000", "BFCFFFFF80000000",
    "3FBDE4A340000000", "BFC555CA00000000", "3FD5555540000000")]
# log1p for |x| < sqrt(2) - 1: x + (-x^2/2 + x^3 * P(x)/Q(x))
_LOG1P_DEN = [_h(c) for c in (
    "3FF0000000000000", "402E2035A0000000", "4054C30B60000000",
    "406BB865A0000000", "4073519460000000", "406B0DB140000000",
    "404E0F3040000000")]
_LOG1P_NUM = [_h(c) for c in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000",
    "403DE97380000000", "404E798EC0000000", "404C8E75A0000000",
    "40340A2020000000")]
# erf_inv: Giles' coefficients, (w < 5, w >= 5) pairs, highest degree first
_ERFINV_C = [(_h(a), _h(b)) for a, b in (
    ("3E5E2CB100000000", "BF2A3E1360000000"),
    ("3E970966C0000000", "3F1A76AD60000000"),
    ("BECD8E6AE0000000", "3F561B8E40000000"),
    ("BED26B5820000000", "BF6E17BCE0000000"),
    ("3F2CA65B60000000", "3F77824F60000000"),
    ("BF548A8100000000", "BF7F38BAE0000000"),
    ("BF711C9DE0000000", "3F8354AFC0000000"),
    ("3FCF91EC60000000", "3FF006DB60000000"),
    ("3FF805C5E0000000", "4006A9EFC0000000"))]
# exp's polynomial, highest degree first
_EXP_C = [_h(c) for c in (
    "3F2A0D2CE0000000", "3F56E879C0000000", "3F81112100000000",
    "3FA5553820000000", "3FC5555540000000")]

_INF_BITS = 0x7F800000
_NINF_BITS = -8388608            # 0xFF800000 as int32
_NAN_BITS = -1                   # 0xFFFFFFFF: XLA's NaN for log(x <= 0)


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _float(b: torch.Tensor) -> torch.Tensor:
    return b.view(torch.float32)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU code runs with denormals flushed to zero (FTZ and DAZ):
    a subnormal input or result is a zero of the same sign."""
    return torch.where(torch.abs(x) < F32_MIN_NORMAL, x * 0.0, x)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt: PyTorch's CPU float32 sqrt is an ulp
    off on some inputs; the float64 root rounds to the IEEE float32 one."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c in float32 with ONE rounding, as the CPU's `vfmadd` and
    CUDA's `__fmaf_rn` compute it.

    PyTorch has no fused multiply-add op it promises to fuse, so this
    works in float64: the product of two float32 is exact there, the sum
    carries its exact error (Knuth's two-sum), and the one case where
    rounding that sum to float32 is not the correctly rounded fma, a sum
    that lands exactly on a float32 midpoint, is decided by the error's
    sign."""
    a = torch.as_tensor(a, dtype=torch.float32)
    dev = a.device
    b = torch.as_tensor(b, dtype=torch.float32, device=dev)
    c = torch.as_tensor(c, dtype=torch.float32, device=dev)
    p = a.to(torch.float64) * b.to(torch.float64)
    cd = c.to(torch.float64)
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    r = s.to(torch.float32)
    rd = r.to(torch.float64)
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(s > rd, inf, -inf))
    mid = (s != rd) & ((rd + other.to(torch.float64)) * 0.5 == s)
    near = torch.where(err > 0, torch.maximum(r, other),
                       torch.minimum(r, other))
    return torch.where(mid & (err != 0), near, r)


def _log_f32(a: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 log (Cephes logf): frexp into a mantissa in
    [sqrt(0.5), sqrt(2)) and an exponent, a degree-9 polynomial."""
    big = torch.where(a > F32_MIN_NORMAL, a, torch.full_like(a,
                                                             F32_MIN_NORMAL))
    ib = _bits(big)
    e = (ib >> 23) - 127                     # the input is positive here
    m = _float((ib & 0x7FFFFF) | 0x3F000000)          # in [0.5, 1)
    e1 = e.to(torch.float32) + 1.0
    small_m = m < SQRT_HALF
    zero = torch.zeros_like(m)
    x = (m + -1.0) + torch.where(small_m, m, zero)
    e2 = e1 - torch.where(small_m, torch.ones_like(m), zero)
    z = x * x
    z3 = z * x
    c = _LOG_C
    p0 = fma_f32(fma_f32(x, c[0], c[1]), x, c[6])
    p1 = fma_f32(fma_f32(x, c[2], c[3]), x, c[7])
    p2 = fma_f32(fma_f32(x, c[4], c[5]), x, c[8])
    p = fma_f32(fma_f32(fma_f32(p0, z3, p1), z3, p2), z3, e2 * LN2_LO)
    r = fma_f32(e2, LN2_HI, p + fma_f32(z, -0.5, x))
    # special values, as XLA selects them on the bits
    ne0, neinf = a != 0, a != float("inf")
    sp = torch.where(neinf, torch.zeros_like(ib), torch.full_like(ib,
                                                                  _INF_BITS))
    sp = torch.where(ne0, sp, torch.full_like(ib, _NINF_BITS))
    rb = torch.where((a <= 0) | torch.isnan(a), torch.full_like(ib,
                                                                _NAN_BITS),
                     _bits(r))
    rb = torch.where(ne0 & neinf, rb, torch.zeros_like(ib))
    return _float(sp | rb)


@lint_opaque
def log2_f32(x: torch.Tensor, divisor: Optional[float] = None
             ) -> torch.Tensor:
    """`jnp.log2(x)` as jitted JAX computes it on the CPU, or
    `jnp.log2(x) / divisor` for a constant float32 `divisor`.

    `jnp.log2` is `log(x) / log(2)`: XLA's log, and the divide by the
    constant turned into a multiply by its float32 reciprocal.  A further
    divide by a constant folds into that one multiply, by f32(f32(1 /
    log 2) * f32(1 / divisor)) (the ABN gamma quantizer's `log2(g) /
    step`).  PyTorch's `log2` differs from it on about 30% of float32
    inputs, and the result is rounded to a gamma level, so one ulp can
    move a level."""
    c = np.float32(1.0) / np.float32(np.log(np.float32(2.0)))
    if divisor is not None:
        c = np.float32(c * (np.float32(1.0) / np.float32(divisor)))
    return _log_f32(x.to(torch.float32)) * float(c)


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    """XLA's EvaluatePolynomial, p = p * x + c from p = 0, as its code
    runs: the first step rounded (x * 0 feeds both of log1p's chains), the
    rest fused."""
    p = x * 0.0 + coeffs[0]
    for c in coeffs[1:]:
        p = fma_f32(p, x, c)
    return p


@lint_opaque
def log1p_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 log1p: a rational approximation below sqrt(2) - 1
    in magnitude, log(1 + x) above."""
    x = ftz(x.to(torch.float32))
    xsq = x * x
    ratio = _poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN)
    small = x + fma_f32(xsq, -0.5, (x * xsq) * ratio)
    return ftz(torch.where(torch.abs(x) < LOG1P_SMALL, small,
                           _log_f32(x + 1.0)))


@lint_opaque
def erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv (`jax.lax.erf_inv`): w = -log1p(-x^2), one
    of Giles' degree-8 polynomials in w - 2.5 (w < 5) or sqrt(w) - 3, times
    x; +/-inf at |x| = 1."""
    x = ftz(x.to(torch.float32))
    lg = log1p_f32(x * -x)
    lt = lg > -5.0                              # w < 5 (False for NaN)
    w = torch.where(lt, -2.5 - lg, sqrt_f32(-lg) + -3.0)

    def coef(i):
        a, b = _ERFINV_C[i]
        return torch.where(lt, torch.full_like(x, a), torch.full_like(x, b))

    p = fma_f32(coef(0), w, coef(1))
    for i in range(2, len(_ERFINV_C)):
        p = fma_f32(w, p, coef(i))
    p = torch.where(torch.abs(x) == 1.0, torch.full_like(x, float("inf")), p)
    return x * p


@lint_opaque
def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 exp (Cephes expf): n = floor(x log2(e) + 1/2)
    clamped to +/-127, a degree-5 polynomial in the reduced argument, times
    2^n built from its bits (so 0 below about -87.3)."""
    x = ftz(x.to(torch.float32))
    x = torch.where(x < EXP_LO, torch.full_like(x, EXP_LO), x)
    x = torch.where(x > EXP_HI, torch.full_like(x, EXP_HI), x)
    n = torch.floor(fma_f32(x, LOG2E, 0.5))
    n = torch.where(n < -127.0, torch.full_like(n, -127.0), n)
    n = torch.where(n > 127.0, torch.full_like(n, 127.0), n)
    r = fma_f32(n, -LN2_LO, fma_f32(n, -LN2_HI, x))
    p = fma_f32(r, _EXP_C[0], _EXP_C[1])
    for c in _EXP_C[2:] + [0.5]:
        p = fma_f32(p, r, c)
    p = 1.0 + fma_f32(p, r * r, r)
    scale = _float((n.to(torch.int32) + 127) << 23)
    return ftz(p * scale)

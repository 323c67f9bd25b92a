"""Analog batch-normalization (ABN): the paper's distribution-aware reshaping.

Counterpart of `repro/core/abn.py`, with the JAX package's gradients.  The
DSCI-ADC implements y = floor(mid + gamma * g0 * dp + beta) where gamma is
realized as a reference-ladder 'zoom' and beta as a 5b charge-injection
offset on the DPL.  Hardware constraints (Sec. III.D): usable gamma values
are powers of two in [1, 32] (Figs. 13, 17, 18); at train time gamma may
be explored at a configurable precision ("gamma bits", Fig. 3b); beta is
a 5b code covering +/-30 mV on the DPL.

The module holds the hardware quantizers (with STE for training), the
folding of learned BN statistics into (gamma, beta), and the
distribution-aware initialisation from observed DP statistics.  Logs are
XLA's (`xla_f32.log2_f32`), powers of two C's `exp2f` (`exp2_f32`) and a
divide by a constant a multiply by its float32 reciprocal, so the
quantizers round as jitted JAX does on the CPU, bit for bit; roots are
correctly rounded (`xla_f32.sqrt_f32`).
"""
from __future__ import annotations

from decimal import Decimal, localcontext
from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO
from repro_torch.core.quantization import _clip, ste, ste_round
from repro_torch.core.xla_f32 import log2_f32, sqrt_f32


def _exp2f_table(n: int = 32) -> np.ndarray:
    """tab[i] = bits(2^(i/n)) - (i << 52)/n, the table of C's exp2f."""
    tab = []
    with localcontext() as ctx:
        ctx.prec = 60
        for i in range(n):
            v = np.float64(float(Decimal(2) ** (Decimal(i) / Decimal(n))))
            tab.append(int(v.view(np.uint64)) - (i << 52) // n)
    return np.array(tab, np.uint64)


_EXP2F_TAB = _exp2f_table()
_EXP2F_POLY = (float.fromhex("0x1.c6af84b912394p-5"),
               float.fromhex("0x1.ebfce50fac4f3p-3"),
               float.fromhex("0x1.62e42ff0c52d6p-1"))
_EXP2F_SHIFT = float.fromhex("0x1.8p+52") / 32


_EXP2F_TAB_BY_DEVICE: dict = {}
_LN2_F32 = float(np.log(np.float32(2.0)))


def _exp2f_table_on(device: torch.device) -> torch.Tensor:
    """The exp2f table as int64 on `device` (its values are below 2^63),
    copied there once."""
    tab = _EXP2F_TAB_BY_DEVICE.get(device)
    if tab is None:
        tab = torch.from_numpy(_EXP2F_TAB.view(np.int64)).to(device)
        _EXP2F_TAB_BY_DEVICE[device] = tab
    return tab


def _exp2f(x: torch.Tensor) -> torch.Tensor:
    """C's exp2f on x's device: float64 and int64 tensor ops, each its own
    kernel (so nothing contracts), in the order of the C function."""
    x = x.to(torch.float32)
    # out-of-range inputs are replaced below; clamping them first keeps
    # the int64 arithmetic free of overflow (NaN stays NaN)
    xd = torch.clamp(x.to(torch.float64), -151.0, 129.0)
    kd = xd + _EXP2F_SHIFT
    ki = kd.view(torch.int64)
    r = xd - (kd - _EXP2F_SHIFT)
    # C adds (ki << 47) in uint64: the low 17 bits of ki are round(32 x)
    # mod 2^17, which as a signed count of 2^47 gives the same sum
    low = ki & 0x1FFFF
    n = torch.where(low >= 1 << 16, low - (1 << 17), low)
    s = (_exp2f_table_on(x.device)[ki & 31] + n * (1 << 47)).view(torch.float64)
    c0, c1, c2 = _EXP2F_POLY
    y = ((c0 * r + c1) * (r * r) + (c2 * r + 1.0)) * s
    out = y.to(torch.float32)
    # the C function's special cases (overflow, inf, nan), and XLA's CPU
    # flush of subnormal results to zero
    out = torch.where(x >= 128.0, torch.inf, out)
    out = torch.where((out < 2.0 ** -126) | (x <= -150.0), 0.0, out)
    return torch.where(torch.isnan(x), x, out)


class _Exp2F32(torch.autograd.Function):
    """2**x with JAX's gradient of `2.0 ** x`: g * (log(2) * y), log(2)
    rounded to float32."""

    @staticmethod
    def forward(ctx, x):
        y = _exp2f(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * (y * _LN2_F32)


def exp2_f32(x: torch.Tensor) -> torch.Tensor:
    """2**x in float32, rounded exactly as the JAX package rounds it, on
    x's device, differentiable in x.

    XLA lowers `2.0 ** x` to `exp2`, which resolves to the C library's
    `exp2f` (a table of 32 powers 2^(i/32) and a cubic in double
    precision).  PyTorch's `pow`/`exp2` use other approximations and
    differ from it by one ulp on about 1.5% of float32 inputs, and gamma
    feeds the ADC floor, so one ulp can move a code.  This is that exp2f
    written out in float64 and int64 tensor ops: same table, same
    polynomial, same order of operations, so the result is the same
    float32 on the CPU and on the card, with no host round trip."""
    return _Exp2F32.apply(x)


def quantize_gamma_pow2(gamma: torch.Tensor, *, max_gamma: float = 32.0,
                        min_gamma: float = 1.0) -> torch.Tensor:
    """Snap gamma to the hardware's power-of-two ladder grid (STE)."""
    g = _clip(gamma, min_gamma, max_gamma)
    return ste(exp2_f32(torch.round(log2_f32(g))), g)


def quantize_gamma_bits(gamma: torch.Tensor, bits: int, *,
                        max_gamma: float = 32.0) -> torch.Tensor:
    """Gamma at a given bit precision (Fig. 3b study): 2^bits log-spaced
    levels between 1 and max_gamma (bits=0 -> fixed unity gain).

    The level index is log2(g) / step with XLA's log and the two constant
    divides folded into one multiply, as jitted JAX computes it
    (`xla_f32.log2_f32`); an eager JAX call divides by the step instead,
    and the two disagree on a few inputs near a level's boundary."""
    if bits <= 0:
        return torch.ones_like(gamma)
    n_levels = 2 ** bits
    g = _clip(gamma, 1.0, max_gamma)
    step = float(log2_f32(torch.tensor(max_gamma, dtype=torch.float32))
                 / (n_levels - 1))
    idx = torch.round(log2_f32(g, divisor=step))
    return ste(exp2_f32(idx * step), g)


def quantize_beta_v(beta_v: torch.Tensor,
                    cfg: CIMMacroConfig = DEFAULT_MACRO) -> torch.Tensor:
    """5b ABN offset: +/-abn_offset_range_v in 2^abn_offset_bits steps."""
    n = 2 ** cfg.abn_offset_bits
    lsb = 2.0 * cfg.abn_offset_range_v / (n - 1)
    r = cfg.abn_offset_range_v
    return ste_round(_clip(beta_v, -r, r) * _recip_f32(lsb)) * lsb


def beta_v_to_codes(beta_v: torch.Tensor, gamma: torch.Tensor, r_out: int,
                    cfg: CIMMacroConfig = DEFAULT_MACRO) -> torch.Tensor:
    """Convert a DPL-referred offset (volts) into ADC code units (Eq. 7:
    the offset is applied before the zoom, so it is scaled by gamma)."""
    lsb_v = cfg.alpha_adc() * cfg.vddh / 2.0 ** (r_out - 1)
    return gamma * beta_v * _recip_f32(lsb_v)


def _recip_f32(c: float) -> float:
    """The float32 reciprocal of a constant divisor: jitted JAX divides
    by a constant as a multiply by it."""
    return float(np.float32(1.0) / np.float32(c))


class ABNParams(NamedTuple):
    """Learnable per-output-channel ABN parameters (pre-hardware)."""
    log_gamma: torch.Tensor   # (N,) gamma = 2**log_gamma  (log2 domain)
    beta: torch.Tensor        # (N,) offset in ADC code units


def init_abn(n: int) -> ABNParams:
    return ABNParams(log_gamma=torch.zeros((n,), dtype=torch.float32),
                     beta=torch.zeros((n,), dtype=torch.float32))


def abn_gamma(params: ABNParams, *, gamma_bits: int = -1,
              max_gamma: float = 32.0) -> torch.Tensor:
    """Effective gamma; gamma_bits<0 keeps it continuous (no HW quant)."""
    g = exp2_f32(params.log_gamma)
    if gamma_bits < 0:
        return _clip(g, 2.0 ** -4, max_gamma)
    return quantize_gamma_bits(g, gamma_bits, max_gamma=min(max_gamma, 32.0))


def fold_batchnorm(bn_scale: torch.Tensor, bn_bias: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor,
                   eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold conventional BN(y) = scale*(y-mean)/sqrt(var+eps)+bias into the
    ABN affine form gamma*y + beta (both in the same units as y).

    The root is correctly rounded and the divide IEEE.  Jitted JAX turns
    scale / sqrt(.) into scale * rsqrt(.), and XLA's CPU rsqrt refines the
    host's reciprocal-root estimate, so the two agree to a few ulp, not
    bit for bit."""
    inv = bn_scale / sqrt_f32(var + eps)
    return inv, bn_bias - mean * inv


def distribution_aware_init(dp_sample: torch.Tensor, r_out: int, *,
                            target_sigma_frac: float = 0.25) -> ABNParams:
    """Distribution-aware reshaping init: choose per-channel gamma/beta so
    the observed DP distribution fills the ADC range (the paper's Fig. 3a
    fix).

    dp_sample: (B, N) pre-ADC dot products in *ADC input units* (i.e.
    already multiplied by the unity-gain code gain g0); gamma scales the
    per-channel population std (`jnp.std`, so correction 0) to
    target_sigma_frac of the half-range, beta centres the mean.  The sums
    over the batch run in PyTorch's order, not XLA's, so the result
    agrees with JAX's to a few ulp."""
    half = 2.0 ** (r_out - 1)
    x = dp_sample.to(torch.float32)
    mu = torch.mean(x, dim=0)
    sd = sqrt_f32(torch.var(x, dim=0, correction=0)) + 1e-6
    num = torch.tensor(target_sigma_frac * half, dtype=torch.float32,
                       device=sd.device)
    gamma = _clip(num / sd, 1.0, 32.0)
    beta = -gamma * mu
    return ABNParams(log_gamma=log2_f32(gamma), beta=beta)

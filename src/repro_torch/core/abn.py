"""Analog batch-normalization (ABN): the paper's distribution-aware reshaping.

Counterpart of `repro/core/abn.py` (gamma and its hardware quantizer, with
the JAX package's gradients).  The DSCI-ADC implements y = floor(mid +
gamma * g0 * dp + beta) where gamma is realized as a reference-ladder
'zoom' and beta as a 5b charge-injection offset on the DPL; gamma may be
explored at a configurable precision ("gamma bits", Fig. 3b).
"""
from __future__ import annotations

from decimal import Decimal, localcontext
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.quantization import _clip, ste


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


def quantize_gamma_bits(gamma: torch.Tensor, bits: int, *,
                        max_gamma: float = 32.0) -> torch.Tensor:
    """Gamma at a given bit precision (Fig. 3b study): 2^bits log-spaced
    levels between 1 and max_gamma (bits=0 -> fixed unity gain)."""
    if bits <= 0:
        return torch.ones_like(gamma)
    n_levels = 2 ** bits
    g = _clip(gamma, 1.0, max_gamma)
    # the JAX package computes the step in f32 (jnp.log2 of the limit);
    # a device tensor keeps the divide IEEE on CUDA as well
    step = torch.log2(torch.tensor(max_gamma, dtype=torch.float32,
                                   device=g.device)) / (n_levels - 1)
    idx = torch.round(torch.log2(g) / step)
    return ste(exp2_f32(idx * step), g)


class ABNParams(NamedTuple):
    """Learnable per-output-channel ABN parameters (pre-hardware)."""
    log_gamma: torch.Tensor   # (N,) gamma = 2**log_gamma  (log2 domain)
    beta: torch.Tensor        # (N,) offset in ADC code units


def abn_gamma(params: ABNParams, *, gamma_bits: int = -1,
              max_gamma: float = 32.0) -> torch.Tensor:
    """Effective gamma; gamma_bits<0 keeps it continuous (no HW quant)."""
    g = exp2_f32(params.log_gamma)
    if gamma_bits < 0:
        return _clip(g, 2.0 ** -4, max_gamma)
    return quantize_gamma_bits(g, gamma_bits, max_gamma=min(max_gamma, 32.0))

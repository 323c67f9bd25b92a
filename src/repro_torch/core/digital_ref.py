"""Exact integer digital-equivalent of the IMAGINE macro datapath.

Counterpart of `repro/core/digital_ref.py`: the ground-truth oracle the
cim_mbiw kernel is held to bit for bit, and the voltage-domain macro
(`core/cim_macro.py`) to within one ADC code without noise.

Numerics
--------
Inputs  X : unsigned integers in [0, 2^r_in - 1]            (shape [..., K])
Weights   : +/-1 bit-planes S[p] in {-1,+1}, p=0..r_w-1      (shape [r_w,K,N])
            encoded value  w = sum_p 2^p * S[p]  (odd ints in +/-(2^r_w - 1))
Dot product  dp = X . w,   |dp| <= K * (2^r_in - 1) * (2^r_w - 1)

The analog chain collapses (with VDDH = 2*VDDL) to the integer relation

    code = clip( floor( 2^(r_out-1)
                        + gamma * swing / (2*alpha_adc)
                          * dp * 2^(r_out-1) / (N_dp * 2^(r_in+r_w))
                        + beta_codes ),  0, 2^r_out - 1 )
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product a @ b as int32, on any device.

    PyTorch has no integer matmul on CUDA, so the product runs in float64:
    every operand and partial sum here is an integer far below 2^53 (one
    macro tile has |dp| <= 1152*255*15 < 2^23), so float64 holds it
    exactly and the cast back to int32 loses nothing.  TF32 never applies
    to float64 products."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int32)


# ---------------------------------------------------------------------------
# weight encoding
# ---------------------------------------------------------------------------

def encode_weight_planes(w_int: torch.Tensor, r_w: int) -> torch.Tensor:
    """Encode odd integers w in [-(2^r_w - 1), 2^r_w - 1] into +/-1 planes.

    Uses u = (w + (2^r_w - 1)) / 2 in [0, 2^r_w - 1]; plane p is 2*bit_p(u)-1.
    Returns int8 tensor of shape (r_w, *w.shape).
    """
    full = 2**r_w - 1
    u = torch.div(w_int.to(torch.int32) + full, 2, rounding_mode="floor")
    planes = [(2 * ((u >> p) & 1) - 1).to(torch.int8) for p in range(r_w)]
    return torch.stack(planes, dim=0)


def decode_weight_planes(planes: torch.Tensor) -> torch.Tensor:
    """Inverse of encode_weight_planes: w = sum_p 2^p * S[p]."""
    r_w = planes.shape[0]
    scale = (2 ** torch.arange(r_w, dtype=torch.int32,
                               device=planes.device)).reshape(
        (r_w,) + (1,) * (planes.dim() - 1))
    return torch.sum(planes.to(torch.int32) * scale, dim=0,
                     dtype=torch.int32)


def quantize_weight_odd(w_int: torch.Tensor, r_w: int) -> torch.Tensor:
    """Snap integers in [-(2^r_w-1), 2^r_w-1] to the representable odd grid."""
    full = 2**r_w - 1
    w = torch.clamp(w_int, -full, full)
    # nearest odd integer: 2*floor(w/2)+1 rounds {2k,2k+1} -> 2k+1
    return (2 * torch.div(w, 2, rounding_mode="floor") + 1).to(torch.int32)


# ---------------------------------------------------------------------------
# integer dot-product (the DP array + MBIW stages)
# ---------------------------------------------------------------------------

def bitplane_dot(x_uint: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """dp = X . W with W decoded from its +/-1 bit-planes.

    x_uint : (..., K) unsigned ints < 2^r_in
    planes : (r_w, K, N) +/-1
    returns: (..., N) int32
    """
    return int_matmul(x_uint, decode_weight_planes(planes))


def bitplane_dot_serial(x_uint: torch.Tensor, planes: torch.Tensor,
                        r_in: int) -> torch.Tensor:
    """Literal input-serial, weight-parallel evaluation (matches the macro's
    MBIW sequencing): dp = sum_k 2^k sum_p 2^p (X[k] . S[p]).
    Provided for the kernel oracle; equal to `x @ decode(planes)`."""
    x = x_uint.to(torch.int32)
    r_w = planes.shape[0]
    acc = torch.zeros(tuple(x.shape[:-1]) + (planes.shape[-1],),
                      dtype=torch.int32, device=x.device)
    for k in range(r_in):
        x_bit = (x >> k) & 1
        per_bit = torch.zeros_like(acc)
        for p in range(r_w):
            per_bit = per_bit + (2**p) * int_matmul(x_bit, planes[p])
        acc = acc + (2**k) * per_bit
    return acc


# ---------------------------------------------------------------------------
# DSCI-ADC (Eq. 7) in code space
# ---------------------------------------------------------------------------

def adc_gain_factor(r_in: int, r_w: int, r_out: int, n_dp: int,
                    swing: float = 1.0, alpha_adc: float = 1.0) -> float:
    """Codes-per-unit-dp of the full chain at gamma=1 (see module docstring)."""
    return swing / (2.0 * alpha_adc) * (2.0 ** (r_out - 1)) / (
        n_dp * 2.0 ** (r_in + r_w))


def dsci_adc_code(dp: torch.Tensor, *, r_in: int, r_w: int, r_out: int,
                  n_dp: int, gamma: torch.Tensor | float = 1.0,
                  beta_codes: torch.Tensor | float = 0.0,
                  swing: float = 1.0, alpha_adc: float = 1.0) -> torch.Tensor:
    """Eq. (7): rescale dp into ADC codes with ABN gain/offset and floor."""
    g = adc_gain_factor(r_in, r_w, r_out, n_dp, swing, alpha_adc)
    mid = 2 ** (r_out - 1)
    code = torch.floor(mid + gamma * g * dp.to(torch.float32) + beta_codes)
    return torch.clamp(code, 0, 2**r_out - 1).to(torch.int32)


def dequantize_code(code: torch.Tensor, *, r_in: int, r_w: int, r_out: int,
                    n_dp: int, gamma: torch.Tensor | float = 1.0,
                    beta_codes: torch.Tensor | float = 0.0,
                    swing: float = 1.0, alpha_adc: float = 1.0
                    ) -> torch.Tensor:
    """Map ADC codes back to dp units (inverse of the ABN-scaled ADC)."""
    g = adc_gain_factor(r_in, r_w, r_out, n_dp, swing, alpha_adc)
    mid = 2 ** (r_out - 1)
    num = code.to(torch.float32) + 0.5 - mid - beta_codes
    den = gamma * g
    if not isinstance(den, torch.Tensor):
        # a device tensor divisor keeps the divide IEEE on CUDA (a Python
        # scalar divisor becomes a reciprocal multiply there)
        den = torch.tensor(den, dtype=torch.float32, device=num.device)
    return num / den


# ---------------------------------------------------------------------------
# end-to-end reference macro
# ---------------------------------------------------------------------------

def cim_matmul_ref(x_uint: torch.Tensor, planes: torch.Tensor, *, r_in: int,
                   r_out: int, gamma: torch.Tensor | float = 1.0,
                   beta_codes: torch.Tensor | float = 0.0,
                   cfg: CIMMacroConfig = DEFAULT_MACRO,
                   n_rows_used: Optional[int] = None,
                   ideal: bool = False) -> torch.Tensor:
    """Digital-equivalent of one macro evaluation.

    x_uint : (..., K) unsigned ints < 2^r_in, K <= cfg.n_rows
    planes : (r_w, K, N) +/-1 weight bit-planes
    gamma/beta_codes : scalars or (N,) per-channel ABN parameters
    ideal  : if True, swing=1 / alpha_adc=1 (parasitic-free); otherwise the
             serial-split swing efficiency for ceil(K/36) units is used.
    returns: (..., N) int32 ADC codes in [0, 2^r_out - 1]
    """
    k_dim = x_uint.shape[-1]
    r_w = planes.shape[0]
    n_rows_used = k_dim if n_rows_used is None else n_rows_used
    units = cfg.units_for_rows(n_rows_used)
    n_dp = units * cfg.rows_per_unit
    swing = 1.0 if ideal else cfg.swing_efficiency(units)
    alpha_adc = 1.0 if ideal else cfg.alpha_adc()
    dp = int_matmul(x_uint, decode_weight_planes(planes))
    return dsci_adc_code(dp, r_in=r_in, r_w=r_w, r_out=r_out, n_dp=n_dp,
                         gamma=gamma, beta_codes=beta_codes, swing=swing,
                         alpha_adc=alpha_adc)

"""One engine-mode CIM projection, written plainly.

The digital equivalent of the IMAGINE macro (arXiv:2412.19750, Eq. 7)
as the port's engine runs it:

1. weights to odd integers in +/-(2^r_w - 1), one scale per output
   column (absmax / (2^r_w - 1));
2. activations to unsigned r_in codes under a dynamic swing: min and max
   over the whole tensor, or over each segment of rows;
3. the reduction split into even row tiles of at most 1152 rows, each an
   exact integer product;
4. each row tile's DSCI-ADC: code = clip(floor((mid + gain * dp) +
   beta_eff), 0, 2^r_out - 1), gain = gamma * g0 (the unity gain of the
   tile's serial-split swing) and beta_eff the ABN offset with the
   activation zero-point folded in;
5. the digital recombination of the tiles' codes in dp units, then the
   dequant by the activation and weight scales.

`dt` is the float type of every step outside the integer products:
float32 as the engine runs them, or a lower one for the control.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

# the macro's geometry and capacitances (IMAGINE: 1152 rows, serial-split
# DPL of 32 units of 36 rows, a 33-unit SAR array)
N_ROWS = 1152
ROWS_PER_UNIT = 36
FF = 1e-15
C_C = 0.7 * FF
C_LOAD_ADC = 40.0 * FF
C_PAR_PER_UNIT = 2.0 * FF
C_SAR = 33 * 0.7 * FF
C_PAR_SAR = 2.0 * FF


def row_tiles(k: int) -> list:
    """Even (start, size) row tiles of a K-long reduction, at most
    N_ROWS rows each."""
    tiles = math.ceil(k / N_ROWS)
    base = math.ceil(k / tiles)
    return [(s, min(base, k - s)) for s in range(0, k, base)]


def unity_gain(k: int, r_in: int, r_w: int, r_out: int) -> float:
    """Codes a dp unit at gamma 1 (Eq. 7 collapsed), for the row tiles of
    a K-long reduction: the DPL connects just the units a tile needs."""
    rows = row_tiles(k)[0][1]
    units = -(-rows // ROWS_PER_UNIT)
    n_dp = units * ROWS_PER_UNIT
    alpha_eff = C_C / (n_dp * C_C + units * C_PAR_PER_UNIT + C_LOAD_ADC)
    swing = n_dp * alpha_eff
    alpha_adc = C_SAR / (C_SAR + C_PAR_SAR)
    return swing / (2.0 * alpha_adc) * (2.0 ** (r_out - 1)) / (
        n_dp * 2.0 ** (r_in + r_w))


def _f32(v: float) -> float:
    """v rounded to float32, as a Python float."""
    return float(torch.tensor(v, dtype=torch.float32))


def int_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer a @ b: float64 holds every operand and partial sum
    here (|dp| < 2^31), and TF32 never applies to float64."""
    return torch.matmul(a.to(torch.float64), b.to(torch.float64))


def quantize_weight(w: torch.Tensor, r_w: int, dt=torch.float32):
    """(odd integer codes (K, N), per-column scale (N,))."""
    full = 2.0 ** r_w - 1.0
    w = w.to(dt)
    amax = torch.amax(torch.abs(w), dim=0, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) * _f32(1.0 / full)
    u = torch.clamp(w / scale, -full, full)
    q = torch.clamp(2.0 * torch.round((u - 1.0) * 0.5) + 1.0, -full, full)
    return q, scale.reshape(-1)


def quantize_act(x: torch.Tensor, r_in: int,
                 segments: Optional[torch.Tensor] = None):
    """(codes (M, K), scale, zero): scale and zero are 0-d, or (M, 1) per
    row with `segments` ((M,) int ids: rows of one id share a swing)."""
    levels = 2.0 ** r_in - 1.0
    inv = _f32(1.0 / levels)
    if segments is None:
        zero = torch.amin(x)
        top = torch.amax(x)
    else:
        n = int(segments.max()) + 1
        ids = segments.to(x.device, torch.int64)
        lo = torch.full((n,), float("inf"), dtype=x.dtype, device=x.device)
        hi = torch.full((n,), float("-inf"), dtype=x.dtype, device=x.device)
        lo = lo.scatter_reduce(0, ids, torch.amin(x, dim=1), "amin")
        hi = hi.scatter_reduce(0, ids, torch.amax(x, dim=1), "amax")
        zero, top = lo[ids][:, None], hi[ids][:, None]
    scale = torch.clamp_min(top - zero, 1e-8) * inv
    q = torch.round(torch.clamp((x - zero) / scale, 0.0, levels))
    return q, scale, zero


def projection(x: torch.Tensor, w: torch.Tensor, log_gamma: torch.Tensor,
               beta: torch.Tensor, *, r_in: int, r_w: int, r_out: int = 8,
               max_gamma: float, segments: Optional[torch.Tensor] = None,
               dt=torch.float32, block: int = 1 << 18) -> torch.Tensor:
    """y (M, N) ~= x (M, K) @ w (K, N) through the macro, in `dt`.

    `log_gamma`, `beta` (N,) are the ABN gain (log2) and offset in codes;
    `segments` ((M,) ids) quantize each segment of rows on its own swing.
    Rows run in blocks of
    `block` (a multiple of 128) after the swing is known."""
    k = w.shape[0]
    mid = 2.0 ** (r_out - 1)
    top_code = 2.0 ** r_out - 1.0
    x = x.to(dt)
    wq, w_scale = quantize_weight(w, r_w, dt)
    gamma = torch.exp2(log_gamma.to(torch.float64)).to(dt)
    gamma = torch.clamp(gamma, 2.0 ** -4, max_gamma)
    beta = beta.to(dt)
    gain = gamma * torch.tensor(unity_gain(k, r_in, r_w, r_out), dtype=dt,
                                device=x.device)
    q, scale, zero = quantize_act(x, r_in, segments)
    zp = zero / scale
    tiles = row_tiles(k)
    out = []
    for r0 in range(0, x.shape[0], block):
        qb = q[r0:r0 + block]
        zb = zp if zp.dim() == 0 else zp[r0:r0 + block]
        acc = torch.zeros((qb.shape[0], w.shape[1]), dtype=dt,
                          device=x.device)
        for ks, ksz in tiles:
            wt = wq[ks:ks + ksz]
            dp = int_product(qb[:, ks:ks + ksz], wt)
            beta_eff = beta + gain * (zb * torch.sum(wt, dim=0))
            code = torch.floor((mid + gain * dp.to(dt)) + beta_eff)
            code = torch.clamp(code, 0.0, top_code)
            acc = acc + (code + 0.5 - mid - beta) / gain
        sb = scale if scale.dim() == 0 else scale[r0:r0 + block]
        out.append(acc * sb * w_scale)
    return torch.cat(out, dim=0)

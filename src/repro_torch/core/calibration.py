"""SA-offset calibration (paper Sec. III.E, Fig. 19).

Counterpart of `repro/core/calibration.py`.  The chip refreshes a 7b
per-column calibration code on a rare basis: the DPL is precharged to VDDL
and a SAR-like search over the calibration unit's binary-weighted caps
converges to the code that cancels the comparator offset.  This is that
search bit by bit: a binary search for -offset on the 0.47 mV grid,
saturating at the +/-(2^7 - 1)/2 LSB range - out-of-range offsets leave
the 'dysfunctional columns' of Fig. 14c.  Float32 throughout, on the
offsets' device (every step multiplies or compares by a float32 constant,
which rounds alike on the CPU and on CUDA).
"""
from __future__ import annotations

import torch

from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO


def calibrate_sar(sa_offset_v: torch.Tensor,
                  cfg: CIMMacroConfig = DEFAULT_MACRO) -> torch.Tensor:
    """Run the 7b calibration search per column.

    sa_offset_v: (N,) true comparator offsets (volts)
    returns    : (N,) compensation voltages the calibration unit applies
    """
    lsb = cfg.cal_lsb_v
    # the differential unit covers +/- cal_range_v with cal_lsb_v steps:
    # an effective (cal_bits + 1)-bit signed search
    n_bits = cfg.cal_bits + 1
    half = float(1 << (n_bits - 1))
    # unsigned SAR over the shifted range: the applied compensation is
    # (u_code - 2^(b-1)) * lsb; each decision compares the offset with the
    # trial level, as the chip's decision/update cycles do
    u_code = torch.zeros_like(sa_offset_v)
    for k in range(n_bits - 1, -1, -1):
        trial = u_code + float(1 << k)
        take = sa_offset_v >= (trial - half) * lsb
        u_code = torch.where(take, trial, u_code)
    comp = (u_code - half) * lsb
    lo = torch.full_like(comp, -cfg.cal_range_v)
    hi = torch.full_like(comp, cfg.cal_range_v)
    return torch.minimum(torch.maximum(comp, lo), hi)


def residual_offsets(sa_offset_v: torch.Tensor,
                     cfg: CIMMacroConfig = DEFAULT_MACRO) -> torch.Tensor:
    """Offset remaining after calibration (what computations see)."""
    return sa_offset_v - calibrate_sar(sa_offset_v, cfg)


def dysfunctional_columns(sa_offset_v: torch.Tensor, r_out: int,
                          cfg: CIMMacroConfig = DEFAULT_MACRO
                          ) -> torch.Tensor:
    """Boolean mask of columns whose residual offset exceeds 1 ADC LSB."""
    lsb_v = cfg.alpha_adc() * cfg.vddh / 2.0 ** (r_out - 1)
    return torch.abs(residual_offsets(sa_offset_v, cfg)) > lsb_v

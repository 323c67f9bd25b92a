"""Voltage-domain behavioural model of the IMAGINE CIM-SRAM macro.

Counterpart of `repro/core/cim_macro.py`: the full analog pipeline of
Sec. III in simulation units of volts:

  1. swing-adaptive charge-based DP      (Eq. 1/4, serial-split DPL)
  2. MBIW input-serial accumulation      (Eq. 5, alpha_mb charge sharing)
  3. MBIW weight-parallel combination    (Eq. 6, pairwise LSB->MSB sharing)
  4. DSCI-ADC with in-conversion ABN     (Eq. 7, SAR loop with gamma 'zoom'
                                          and 5b offset), SA offset +
                                          7b calibration residue

With `noise=NO_NOISE` the model is the digital reference of
`core/digital_ref.py` to within one ADC code (float32 rounding at code
boundaries).  Under a key the PRNG stream is the JAX package's: the key
splits once for the SA offsets (when none are given), once per weight
plane for its thermal draw and once for the ladder mismatch, and every
normal comes from the draw kernel's wrapper (`noise_model.draw_normal`),
on x's device.

Shapes: x_uint (B, K) unsigned < 2^r_in; planes (r_w, K, N) in {-1,+1}.
The model evaluates ONE macro tile (K <= 1152, N <= 64 output channels when
r_w=4); layer-level tiling lives in core/mapping.py.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import noise_model as nm
from repro_torch.core import prng
from repro_torch.core.digital_ref import int_matmul
from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO
from repro_torch.core.noise_model import NO_NOISE, NoiseConfig
from repro_torch.core.xla_f32 import sqrt_f32


def dp_bit_voltage(x_bit: torch.Tensor, plane_dot: torch.Tensor,
                   alpha_eff: float, settle: torch.Tensor,
                   cfg: CIMMacroConfig) -> torch.Tensor:
    """DPL deviation (from the VDDL precharge) after one single-bit DP.

    plane_dot : (B, N) = sum_i x_bit_i * s_i  already computed by caller;
    settle a 0-d float32 host tensor (`noise_model.settle_fraction`).
    """
    del x_bit
    return settle * alpha_eff * cfg.vddl * plane_dot


def mbiw_input_accumulate(per_bit_dev: torch.Tensor, *, r_in: int,
                          noise: NoiseConfig, cfg: CIMMacroConfig,
                          key: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Eq. (5): accumulate per-input-bit DP deviations, LSB first, through
    alpha_mb ~= 1/2 charge sharing.  per_bit_dev: (r_in, B, N) volts.

    Returns the accumulated deviation from VDDL (B, N)."""
    alpha_mb = cfg.alpha_mb()
    v_acc = torch.zeros_like(per_bit_dev[0])      # deviation from VDDL
    for k in range(r_in):
        v_in = per_bit_dev[k]
        v_next = alpha_mb * v_acc + (1.0 - alpha_mb) * v_in
        if noise.enabled:
            v_next = v_next + nm.charge_injection_error(
                v_in + cfg.vddl, v_acc + cfg.vddl, noise, cfg)
        v_acc = v_next
    if noise.enabled:
        v_acc = v_acc - nm.leakage_droop(r_in, cfg.t_dp_ns, noise)
        if key is not None:
            v_acc = v_acc + nm.sample_thermal(key, v_acc.shape, noise, cfg,
                                              device=v_acc.device)
    return v_acc


def mbiw_weight_combine(per_plane_dev: torch.Tensor, r_w: int
                        ) -> torch.Tensor:
    """Eq. (6): pairwise inter-column charge sharing, LSB -> MSB.

    per_plane_dev: (r_w, B, N) accumulated deviations per weight plane.
    The LSB plane is first halved against the VDDL-precharged node, then
    each sharing with the next plane halves again:
        V = sum_p 2^(p - r_w) * V_p    (deviation units)."""
    v = 0.5 * per_plane_dev[0]                    # self-weighting of the LSB
    for p in range(1, r_w):
        v = 0.5 * (v + per_plane_dev[p])
    return v


def dsci_adc(v_dev: torch.Tensor, *, r_out: int, gamma: torch.Tensor,
             beta_v: torch.Tensor, sa_offset_v: torch.Tensor,
             cfg: CIMMacroConfig, noise: NoiseConfig = NO_NOISE,
             key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DSCI SAR conversion with the ABN gamma 'zoom' (Eq. 7).

    v_dev      : (B, N) DPL deviation from VDDL at conversion start
    gamma      : 0-d or (N,) float32 ABN gain (reference-ladder zoom)
    beta_v     : 0-d or (N,) float32 ABN offset *in volts on the DPL*
    sa_offset_v: (N,) residual comparator offset after calibration
    returns    : (B, N) int32 codes in [0, 2^r_out - 1]

    The SAR loop compares the (offset-shifted) residue against binary-
    scaled thresholds whose magnitude is divided by gamma - the 'zoom' -
    and whose steps can carry ladder mismatch (gamma-dependent INL, Fig.
    13): one draw of r_out normals, shared across columns.
    """
    alpha_adc = cfg.alpha_adc()
    v = v_dev + beta_v + sa_offset_v              # Eq. (7) numerator terms
    # one ADC code in volts, after the zoom (an IEEE divide: a Python
    # float over a tensor would be a reciprocal times the float)
    dev = v.device
    lsb_v = torch.tensor(alpha_adc * cfg.vddh, dtype=torch.float32,
                         device=dev) / (gamma * 2.0 ** (r_out - 1))
    mid = 2 ** (r_out - 1)
    if noise.enabled and key is not None:
        step_sigma = 0.0015 * sqrt_f32(gamma.to(torch.float32))
        eta = nm.draw_normal(key, (r_out,), dev)
    else:
        step_sigma = torch.zeros((), dtype=torch.float32, device=dev)
        eta = torch.zeros((r_out,), dtype=torch.float32, device=dev)
    code = torch.zeros(v.shape, dtype=torch.int32, device=dev)
    for k in range(r_out - 1, -1, -1):            # MSB first
        trial = code + (1 << k)
        thresh = (trial.to(torch.float32) - mid) * lsb_v \
            * (1.0 + step_sigma * eta[r_out - 1 - k])
        code = torch.where(v >= thresh, trial, code)
    return torch.clamp(code, 0, 2 ** r_out - 1)


def cim_macro_forward(
    x_uint: torch.Tensor, planes: torch.Tensor, *, r_in: int, r_out: int,
    gamma: torch.Tensor | float = 1.0, beta_v: torch.Tensor | float = 0.0,
    cfg: CIMMacroConfig = DEFAULT_MACRO, noise: NoiseConfig = NO_NOISE,
    key: Optional[torch.Tensor] = None,
    sa_offset_v: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """End-to-end analog evaluation of one macro tile, on x_uint's device.

    x_uint : (B, K) unsigned ints < 2^r_in  (K <= cfg.n_rows)
    planes : (r_w, K, N) in {-1, +1}
    key    : a host `core/prng` key; with noise enabled it seeds the SA
             offsets (unless given), the thermal draws and the ladder
             mismatch.
    """
    b, k_dim = x_uint.shape
    r_w, k2, n = planes.shape
    if k_dim != k2:
        raise ValueError(f"x has K={k_dim} rows, planes {k2}")
    dev = x_uint.device
    units = cfg.units_for_rows(k_dim)
    alpha_eff = cfg.alpha_eff(units)
    settle = nm.settle_fraction(units, cfg.t_dp_ns, noise)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=dev)
    beta_v = torch.as_tensor(beta_v, dtype=torch.float32, device=dev)

    if sa_offset_v is None:
        if noise.enabled and key is not None:
            key, sub = prng.split(key)
            raw = nm.sample_sa_offsets(sub, n, noise, cfg, device=dev)
            sa_offset_v = nm.calibration_residue(raw, noise, cfg)
        else:
            sa_offset_v = torch.zeros((n,), dtype=torch.float32, device=dev)

    x = x_uint.to(torch.float32)
    # per (input bit, weight plane) single-bit DPs; each is an integer of
    # at most K in magnitude, exact in any order
    per_plane = []
    for p in range(r_w):
        per_bit = []
        for kbit in range(r_in):
            x_bit = torch.remainder(torch.floor(x / 2 ** kbit), 2.0)
            dot = int_matmul(x_bit, planes[p]).to(torch.float32)
            per_bit.append(dp_bit_voltage(x_bit, dot, alpha_eff, settle,
                                          cfg))
        sub = None
        if key is not None:
            key, sub = prng.split(key)
        per_plane.append(mbiw_input_accumulate(
            torch.stack(per_bit), r_in=r_in, noise=noise, cfg=cfg, key=sub))
    v_mbiw = mbiw_weight_combine(torch.stack(per_plane), r_w)   # (B, N)

    sub = None
    if key is not None:
        key, sub = prng.split(key)
    return dsci_adc(v_mbiw, r_out=r_out, gamma=gamma, beta_v=beta_v,
                    sa_offset_v=sa_offset_v, cfg=cfg, noise=noise, key=sub)

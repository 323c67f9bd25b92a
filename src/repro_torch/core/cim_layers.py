"""CIM layer configuration and initialisation.

Counterpart of `repro/core/cim_layers.py` for what the engine path reads:
the per-layer `CIMConfig`, the distribution-aware initialisation and the
unity-gain code gain.  The layer execution modes (bypass, fakequant, sim,
engine) are not ported yet; a whole network runs through
`runtime.program.compile_program` instead.

Parameters per layer: {"w": (K, N) fp32 master weights,
                       "abn_log_gamma": (N,), "abn_beta": (N,)}.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from repro_torch.core import digital_ref
from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """Per-layer CIM execution configuration."""
    mode: str = "fakequant"          # only "engine" runs in this port
    r_in: int = 8
    r_w: int = 4
    r_out: int = 8
    adaptive_swing: bool = True      # serial-split DPL swing adaptation
    gamma_bits: int = -1             # -1: continuous gamma; >=0: HW quant
    max_gamma: float = 32.0          # resistive-ladder limit
    macro: CIMMacroConfig = DEFAULT_MACRO

    def replace(self, **kw) -> "CIMConfig":
        """A copy of this config with the given fields replaced."""
        return dataclasses.replace(self, **kw)


def analytic_log_gamma_init(k: int, cfg: CIMConfig,
                            target_frac: float = 0.25) -> float:
    """Distribution-aware gamma init (no calibration data needed): scale the
    expected DP std of one macro row-tile to `target_frac` of the ADC
    half-range.  Assumes amax-scaled ~N activations/weights, for which the
    integer codes have std ~2^r_in/8 and ~2^(r_w-1)/2."""
    k_tile = -(-k // (-(-k // cfg.macro.n_rows)))   # rows per even row tile
    g0 = _code_gain(cfg, k)
    sigma_dp = (k_tile ** 0.5) * (2.0 ** cfg.r_in / 8.0) \
        * (2.0 ** (cfg.r_w - 1) / 2.0)
    gamma = target_frac * 2.0 ** (cfg.r_out - 1) / (g0 * sigma_dp)
    gamma = min(max(gamma, 1.0), float(cfg.max_gamma))
    return math.log2(gamma)


def init_cim_linear(generator: torch.Generator, k: int, n: int,
                    w_init_scale: Optional[float] = None,
                    cfg: Optional[CIMConfig] = None) -> Dict:
    """Init one CIM linear on the host: fan-in-scaled weights drawn from
    `generator`, plus the per-output-column ABN gain/offset (gamma seeded
    analytically when `cfg` is given, else unity)."""
    scale = w_init_scale if w_init_scale is not None else (1.0 / k) ** 0.5
    lg = 0.0 if cfg is None else analytic_log_gamma_init(k, cfg)
    return {
        "w": scale * torch.randn((k, n), generator=generator,
                                 dtype=torch.float32),
        "abn_log_gamma": torch.full((n,), lg, dtype=torch.float32),
        "abn_beta": torch.zeros((n,), dtype=torch.float32),
    }


def _code_gain(cfg: CIMConfig, k_dim: int) -> float:
    """Unity-gain codes-per-integer-dp (Eq. 7 collapsed, digital_ref).

    K > n_rows splits into the even row tiles of mapping.map_layer, so the
    swing (and hence g0) follows rows-per-tile - in lockstep with the
    runtime engine's per-tile ADC configuration."""
    macro = cfg.macro
    if cfg.adaptive_swing:
        row_tiles = -(-k_dim // macro.n_rows)
        rows = -(-k_dim // row_tiles)
        units = macro.units_for_rows(rows)
    else:
        units = macro.n_units          # fixed full-array swing (baseline)
    n_dp = units * macro.rows_per_unit
    swing = macro.swing_efficiency(units)
    return digital_ref.adc_gain_factor(cfg.r_in, cfg.r_w, cfg.r_out, n_dp,
                                       swing, macro.alpha_adc())


def _engine_config(cfg: CIMConfig):
    """The runtime EngineConfig mirroring a layer-level CIMConfig (so equal
    layer configs hit one program-cache entry)."""
    from repro_torch.runtime import engine as rt
    return rt.EngineConfig(macro=cfg.macro, adaptive_swing=cfg.adaptive_swing,
                           gamma_bits=cfg.gamma_bits, max_gamma=cfg.max_gamma)

"""Post-silicon equivalent noise model of the IMAGINE macro.

Counterpart of `repro/core/noise_model.py`: every analog non-ideality the
paper measures or simulates, as a term the fakequant training forward and
the engine's noise epilogue inject (paper Sec. III.E, V.A):

  * thermal / kT-C noise     -> Gaussian on the MBIW voltage (0.52 LSB_8b
                                RMS at gamma = 1, Fig. 18a);
  * StrongArm SA offset      -> per-column static Gaussian (sigma 20 mV
                                pre-layout, x1.75 post-layout, Fig. 14b),
                                compensated by the 7b calibration unit
                                (core/calibration.py, Fig. 19);
  * DPL settling INL         -> first-order RC settling of the serial-split
                                DPL (Fig. 8b,c);
  * charge injection (MBIW)  -> bilinear error map on (V_in, V_acc)
                                (Fig. 10c);
  * leakage                  -> linear droop on V_acc (Fig. 10a).

Units: `_v` functions return volts, `*_dp` quantities are integer dot-
product units, `*_codes` ADC codes.

Numbers follow the JAX package's two kinds of arithmetic.  A
`NoiseConfig` holding Python floats computes its scalars in Python
doubles, as JAX does eagerly or with the config static under `jit`; the
engine hands the functions `leaves(noise)` instead, whose numeric fields
are 0-d float32 tensors on the host, as the JAX engine's traced pytree
leaves are float32 under `jit`.  Keep those leaves on the CPU: a CUDA
divide by a Python scalar is a reciprocal multiply, not the IEEE divide.
Normals come from `core/prng` through the draw kernel's wrapper, and
`settle_fraction`'s exp is XLA's (`core/xla_f32.exp_f32`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO
from repro_torch.core.xla_f32 import exp_f32


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """One operating point of the equivalent noise model.  Field units are
    noted inline - volts unless stated otherwise.  `enabled` and
    `calibrated` are the static flags; the rest are numbers."""
    enabled: bool = True
    # thermal noise, expressed as RMS in 8b ADC LSBs at gamma=1 (measured)
    thermal_rms_lsb8: float = 0.52
    # StrongArm sense-amp offset
    sa_sigma_v: float = 0.020           # pre-layout sigma (3-sigma = 60 mV)
    sa_postlayout_mult: float = 1.75    # Fig. 14b: +75% post-layout
    calibrated: bool = True             # apply the 7b calibration unit
    # DPL settling (serial-split transmission gates)
    tau0_ns: float = 0.50               # settling tau with one unit connected
    tau_per_unit_ns: float = 0.016      # series-R growth per connected unit
    # charge injection error map (volts of error per volt of node deviation)
    kappa_in: float = 0.0024
    kappa_acc: float = 0.0016
    # leakage droop on the accumulation cap
    leak_v_per_us: float = 2.0e-4

    @staticmethod
    def none() -> "NoiseConfig":
        """The disabled operating point (same object shape as NO_NOISE)."""
        return NoiseConfig(enabled=False)

    def replace(self, **kw) -> "NoiseConfig":
        """A copy with the given fields replaced (dataclasses.replace)."""
        return dataclasses.replace(self, **kw)


NO_NOISE = NoiseConfig(enabled=False)

# the numeric fields: float32 leaves under the JAX engine's jit
LEAF_FIELDS = (
    "thermal_rms_lsb8", "sa_sigma_v", "sa_postlayout_mult", "tau0_ns",
    "tau_per_unit_ns", "kappa_in", "kappa_acc", "leak_v_per_us")


def leaves(noise: NoiseConfig) -> NoiseConfig:
    """The config with each numeric field a 0-d float32 tensor on the host:
    the noise model then computes in float32 exactly where the JAX
    engine's traced leaves do (its Python-double constants still fold in
    double first)."""
    return dataclasses.replace(noise, **{
        f: torch.tensor(float(getattr(noise, f)), dtype=torch.float32)
        for f in LEAF_FIELDS})


def draw_normal(key: torch.Tensor, shape: Sequence[int],
                device=None) -> torch.Tensor:
    """`jax.random.normal(key, shape)` on `device` (default: the key's),
    through the draw kernel's wrapper: the CUDA kernel for a CUDA device,
    its plain version on the CPU."""
    from repro_torch.kernels.prng.kernel import threefry_normal
    n = 1
    for s in shape:
        n *= int(s)
    k = torch.as_tensor(key).reshape(1, 2).to(device or key.device)
    return threefry_normal(k, n).reshape(tuple(shape))


def lsb8_volts(cfg: CIMMacroConfig = DEFAULT_MACRO) -> float:
    """Voltage of one 8b ADC LSB at unity gain (full scale ~ VDDH)."""
    return cfg.vddh / 2.0**8


def thermal_sigma_v(noise: NoiseConfig, cfg: CIMMacroConfig):
    """Thermal kT/C RMS on the MBIW voltage in volts (the measured 0.52
    LSB_8b at gamma=1, Fig. 18a, referred through the 8b LSB)."""
    return noise.thermal_rms_lsb8 * lsb8_volts(cfg)


def sample_thermal(key: torch.Tensor, shape, noise: NoiseConfig,
                   cfg: CIMMacroConfig = DEFAULT_MACRO,
                   dtype=torch.float32, device=None) -> torch.Tensor:
    """Gaussian thermal-noise draw in volts with the configured RMS; zeros
    of `dtype` when the model is disabled (the dtype is honored either
    way)."""
    if not noise.enabled:
        return torch.zeros(tuple(shape), dtype=dtype,
                           device=device or key.device)
    z = draw_normal(key, shape, device)
    return (_scalar(thermal_sigma_v(noise, cfg)) * z).to(dtype)


def thermal_sigma_dp(noise: NoiseConfig, r_out: int, g0: float):
    """Thermal kT/C RMS referred to integer dp units through the code gain:
    0.52 LSB_8b RMS -> r_out-bit codes via 2^(r_out-8) -> dp units via
    g0.  The fakequant path and the engine's epilogue both draw their
    thermal term from this expression."""
    if not noise.enabled:
        return 0.0
    return noise.thermal_rms_lsb8 * 2.0 ** (r_out - 8) / g0


def sample_sa_offsets(key: torch.Tensor, n_cols: int, noise: NoiseConfig,
                      cfg: CIMMacroConfig = DEFAULT_MACRO,
                      device=None) -> torch.Tensor:
    """Per-column static SA offsets in volts (post-layout)."""
    if not noise.enabled:
        return torch.zeros((n_cols,), dtype=torch.float32,
                           device=device or key.device)
    return sa_offsets_from_normal(draw_normal(key, (n_cols,), device), noise)


def sa_offsets_from_normal(z: torch.Tensor, noise: NoiseConfig
                           ) -> torch.Tensor:
    """sigma * z with sigma = sa_sigma_v * sa_postlayout_mult: the offsets
    of a drawn standard normal (callers that draw it with other streams
    in one launch pass it here)."""
    sigma = noise.sa_sigma_v * noise.sa_postlayout_mult
    return _scalar(sigma) * z


def calibration_residue(offsets_v: torch.Tensor, noise: NoiseConfig,
                        cfg: CIMMacroConfig = DEFAULT_MACRO) -> torch.Tensor:
    """Residual offset after the 7b calibration unit (the SAR search of
    core/calibration.py; offsets outside its range saturate)."""
    if not noise.calibrated:
        return offsets_v
    from repro_torch.core.calibration import residual_offsets
    return residual_offsets(offsets_v, cfg)


def settle_fraction(n_units_on, t_dp_ns: float,
                    noise: NoiseConfig) -> torch.Tensor:
    """Fraction of the final DPL deviation reached after T_dp (Fig. 8b):
    1 - exp(-T_dp / tau), tau = tau0 + tau_per_unit * n, in float32 on the
    host (`n_units_on` an int or an array of unit counts)."""
    n = torch.as_tensor(n_units_on, dtype=torch.float32).cpu()
    if not noise.enabled:
        return torch.ones_like(n)
    tau = noise.tau0_ns + noise.tau_per_unit_ns * n
    t = torch.tensor(t_dp_ns, dtype=torch.float32)
    return 1.0 - exp_f32(-t / tau)


def charge_injection_error(v_in: torch.Tensor, v_acc: torch.Tensor,
                           noise: NoiseConfig,
                           cfg: CIMMacroConfig = DEFAULT_MACRO
                           ) -> torch.Tensor:
    """Deterministic MBIW charge-injection error (volts), Fig. 10c: the
    zero-error locus is v_in ~ (kappa_acc / kappa_in) * v_acc."""
    v_in, v_acc = torch.as_tensor(v_in), torch.as_tensor(v_acc)
    if not noise.enabled:
        return torch.zeros(torch.broadcast_shapes(v_in.shape, v_acc.shape),
                           dtype=torch.result_type(v_in, v_acc),
                           device=v_in.device)
    mid = cfg.vddl
    return (_scalar(noise.kappa_in) * (v_in - mid)
            - _scalar(noise.kappa_acc) * (v_acc - mid))


def leakage_droop(r_in: int, t_dp_ns: float, noise: NoiseConfig):
    """Accumulated V_acc droop (volts) over the input-serial window."""
    if not noise.enabled:
        return 0.0
    window_us = r_in * 2.0 * t_dp_ns * 1e-3
    return noise.leak_v_per_us * window_us


def channels_per_col_tile(r_w: int, cfg: CIMMacroConfig = DEFAULT_MACRO
                          ) -> int:
    """Output channels one macro col tile carries (cf. mapping.map_layer):
    one channel per 4-column block at r_w in (3, 4), more at narrow
    weights."""
    return cfg.n_blocks * max(1, cfg.cols_per_block // r_w)


def column_residues_from_offsets(raw_v: torch.Tensor, n_channels: int,
                                 r_w: int, noise: NoiseConfig,
                                 cfg: CIMMacroConfig = DEFAULT_MACRO
                                 ) -> torch.Tensor:
    """The calibrated residues of the `cfg.n_cols` physical offsets
    `raw_v`, gathered per logical output channel (see
    sample_column_residues)."""
    res = calibration_residue(raw_v, noise, cfg)
    ch_per_tile = channels_per_col_tile(r_w, cfg)
    c = torch.arange(n_channels, device=res.device) % ch_per_tile
    return res[c * (cfg.n_cols // ch_per_tile)]


def sample_column_residues(key: torch.Tensor, n_channels: int, r_w: int,
                           noise: NoiseConfig,
                           cfg: CIMMacroConfig = DEFAULT_MACRO,
                           device=None) -> torch.Tensor:
    """Calibrated SA-offset residues per *logical* output channel (volts).

    The physical offsets are static per macro column: there are exactly
    `cfg.n_cols` comparators, sampled once, and a layer with more output
    channels than one col tile carries reuses them sequentially, so
    logical channels j and j + channels_per_col_tile see the same residue.
    Channel c inside a tile owns r_w adjacent columns of its block; its
    comparator sits at column c * (n_cols / ch_per_tile)."""
    raw = sample_sa_offsets(key, cfg.n_cols, noise, cfg, device)
    return column_residues_from_offsets(raw, n_channels, r_w, noise, cfg)


def charge_injection_gain(r_in: int, noise: NoiseConfig,
                          cfg: CIMMacroConfig = DEFAULT_MACRO):
    """Equivalent multiplicative error of the MBIW charge injection,
    referred to the final accumulated voltage (a gain term on g0): to
    first order in kappa, the recursion v_{k+1} = (a - kappa_acc) v_k +
    (1 - a + kappa_in) u_k with a = alpha_mb accumulates an error
    proportional to the ideal final voltage with this constant."""
    if not noise.enabled:
        return 0.0
    a = cfg.alpha_mb()
    geo = (1.0 - a ** r_in) / (1.0 - a)
    err = (noise.kappa_in * geo
           - noise.kappa_acc * (geo - r_in * a ** (r_in - 1)))
    return err / (1.0 - a ** r_in)


def _scalar(scale):
    """A scalar factor ready to multiply a tensor: a Python float as it is
    (PyTorch rounds it to float32 as JAX rounds a weak-typed scalar); a
    0-d float32 leaf as the Python float of its value, which rounds back
    to itself, so a product on the card needs no copy to the device."""
    if isinstance(scale, torch.Tensor):
        return float(scale)
    return scale

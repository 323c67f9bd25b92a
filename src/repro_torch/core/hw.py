"""Hardware constants and configuration for the IMAGINE CIM-SRAM macro.

Counterpart of `repro/core/hw.py`: the macro description, and in place
of the TPU roofline table there, the one table of the card the port runs
on (`GPUSpec`, `H100_SXM`), which the schedule tuner's cost model and
`chip_smoke.py`'s bounds both read.

All values come from the paper (Kneip et al., 2024, 22nm FD-SOI CERBERUS):
  - 1152x256 DP array, 32 DP units of 36 rows (3x3 kernel x C_in=4 granule)
  - 64 analog cores of 4 columns each (1-4b weights, one output ch / core)
  - 10T1C bitcell with C_c = 0.7 fF MoM cap, 0.44 um^2
  - serial-split DPL, ADC load C_L = 40 fF/column after voltage-split DAC
  - DSCI SAR ADC: 8b SAR (C_sar = 33*C_c), 5b ABN offset (+/-30 mV),
    7b calibration (0.47 mV resolution, 4*C_c MSB)
  - V_DDL/V_DDH = 0.4/0.8 V nominal (down to 0.28/0.56 V measured)
"""
from __future__ import annotations

import dataclasses

FF = 1e-15  # farad


@dataclasses.dataclass(frozen=True)
class CIMMacroConfig:
    """Static description of one CIM-SRAM macro instance."""

    # --- array geometry -------------------------------------------------
    n_rows: int = 1152              # DP rows (bitcells per column)
    n_cols: int = 256               # physical columns
    n_units: int = 32               # serial-split DPL units
    rows_per_unit: int = 36         # 3x3 kernel x C_in granule of 4
    cols_per_block: int = 4         # weight-bit columns per analog core
    # --- capacitances (farads) ------------------------------------------
    c_c: float = 0.7 * FF           # bitcell MoM computing cap
    c_load_adc: float = 40.0 * FF   # total non-DP load on the DPL (ADC dom.)
    c_par_per_unit: float = 2.0 * FF  # metal routing parasitics per unit
    c_sar: float = 33 * 0.7 * FF    # SAR array total capacitance
    c_par_sar: float = 2.0 * FF     # SAR parasitics
    # --- supplies --------------------------------------------------------
    vddl: float = 0.4               # analog DP supply (precharge level)
    vddh: float = 0.8               # ADC / reference supply
    # --- precision -------------------------------------------------------
    max_r_in: int = 8
    max_r_w: int = 4
    max_r_out: int = 8
    # --- ABN / calibration hardware --------------------------------------
    abn_offset_bits: int = 5        # +/-30 mV on the DPL
    abn_offset_range_v: float = 0.030
    cal_bits: int = 7               # SA-offset calibration unit
    cal_lsb_v: float = 0.47e-3      # calibration resolution
    cal_range_v: float = 0.060      # +/- range (3-sigma pre-layout offset)
    gamma_max_msb: int = 16         # max gain of the MSB split DAC
    gamma_max: int = 32             # max usable gain (ladder limit VDDH/32)
    # --- timing (ns), from Fig. 8 ----------------------------------------
    t_dp_ns: float = 5.0            # single-bit DP duration (serial-split)
    t_dp_cfg_ns: float = 1.0        # +/- configurability range
    t_adc_bit_ns: float = 5.0       # per SAR decision+update cycle

    @property
    def n_blocks(self) -> int:
        return self.n_cols // self.cols_per_block

    def alpha_eff(self, n_units_on: int) -> float:
        """Eq. (4) with the serial-split DPL: both the DP capacitance and the
        routing parasitics scale with the number of connected units, while the
        ADC-side load C_L is constant."""
        if not 1 <= n_units_on <= self.n_units:
            raise ValueError(f"n_units_on={n_units_on} not in [1,{self.n_units}]")
        n_dp = n_units_on * self.rows_per_unit
        c_p = n_units_on * self.c_par_per_unit
        return self.c_c / (n_dp * self.c_c + c_p + self.c_load_adc)

    def swing_efficiency(self, n_units_on: int) -> float:
        """N_dp * alpha_eff: the fraction of the ideal (parasitic-free) DPL
        swing actually reached at a given split configuration."""
        n_dp = n_units_on * self.rows_per_unit
        return n_dp * self.alpha_eff(n_units_on)

    def alpha_mb(self) -> float:
        """Multi-bit attenuation (Eq. 5): C_acc is sized to equal the
        remaining DPL load (C_mb + C_adc), giving ~1/2."""
        return 0.5

    def alpha_adc(self) -> float:
        """SAR attenuation alpha_adc = C_sar / (C_sar + C_p,sar)  (Eq. 7)."""
        return self.c_sar / (self.c_sar + self.c_par_sar)

    def units_for_rows(self, n_rows_used: int) -> int:
        """Smallest number of serial-split units covering `n_rows_used`."""
        if n_rows_used < 1:
            raise ValueError("need at least one active row")
        if n_rows_used > self.n_rows:
            raise ValueError(f"{n_rows_used} rows > array height {self.n_rows}")
        return -(-n_rows_used // self.rows_per_unit)


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """Published peaks of one NVIDIA card (dense rates, no sparsity, at
    the full power limit).  `int32_ops` counts 32-bit integer lane
    instructions a second (one multiply-add each); the CUDA-core routes of
    `cim_mbiw` are priced from it."""
    name: str
    int8_ops: float          # op/s, int8 tensor cores
    bf16_flops: float        # FLOP/s, bf16 tensor cores
    f32_flops: float         # FLOP/s, float32 outside the tensor cores
    int32_ops: float         # instructions/s, 32-bit integer lanes
    hbm_bw: float            # byte/s
    sms: int
    hbm_bytes: float
    l2_bytes: int
    smem_per_sm: int         # bytes of shared memory an SM holds
    nvlink_bw: float         # byte/s one card receives over NVLink


DEFAULT_MACRO = CIMMacroConfig()
# NVIDIA's H100 SXM data sheet and Hopper white paper (700 W); the int32
# rate is 64 lanes x 132 SMs x 1.98 GHz.  NVLink: the data sheet's
# 900 GB/s is both directions of 18 fourth-generation links; one card
# receives at most half of it.  A specification, not a measurement.
H100_SXM = GPUSpec(name="h100_sxm", int8_ops=1979e12, bf16_flops=989e12,
                   f32_flops=67e12, int32_ops=16.7e12, hbm_bw=3.35e12,
                   sms=132, hbm_bytes=80e9, l2_bytes=50 * 2**20,
                   smem_per_sm=228 * 2**10, nvlink_bw=450e9)

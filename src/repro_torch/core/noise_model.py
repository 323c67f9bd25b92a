"""The post-silicon noise model's operating point.

Counterpart of `repro/core/noise_model.py`'s `NoiseConfig` / `NO_NOISE`
only: the switch a `CIMConfig` carries.  Drawing noise (thermal,
sense-amp residues, settling) is not ported; a fakequant projection with
noise on raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """One operating point of the equivalent noise model.  Only the
    on/off flag is ported; the JAX package's numeric fields (thermal,
    sense-amp, settling, charge-injection, leakage) come with noise."""
    enabled: bool = True


NO_NOISE = NoiseConfig(enabled=False)

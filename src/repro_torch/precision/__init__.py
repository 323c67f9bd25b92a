"""Workload-adaptive precision serving: the profile -> plan -> ladder ->
per-request dispatch pipeline, the port's copy of `repro.precision`.

The paper's 0.15-8 POPS/W range is a *precision* axis - this package
turns the full r_in x r_w grid from a test matrix into a serving
feature.  Three layers:

* `sensitivity` - offline per-layer precision/noise sensitivity
  calibration (Monte-Carlo quality deltas vs. the 8b-class reference),
  persisted in a versioned on-disk profile cache;
* `planner` - greedy accuracy-budget assignment of per-layer precisions
  and compilation of the named operating-point ladder (`quality` /
  `balanced` / `throughput`) through the global program cache;
* per-request selection lives in `runtime/scheduler.py`: requests carry
  an operating-point tag, and the in-flight scheduler fuses only
  same-point requests per decode step.
"""
from repro_torch.precision.sensitivity import (BASE_POINT, CALIBRATION_RUNS,
                                               PRECISION_CHAIN,
                                               LayerSensitivity,
                                               ProfileCache,
                                               ProfileCacheWarning,
                                               SensitivityProfile, calibrate,
                                               default_profile_path,
                                               profile_key)
from repro_torch.precision.planner import (DEFAULT_BUDGETS, OperatingPoint,
                                           PrecisionLadder, assign,
                                           plan_ladder)

__all__ = [
    "BASE_POINT", "CALIBRATION_RUNS", "PRECISION_CHAIN",
    "LayerSensitivity", "ProfileCache", "ProfileCacheWarning",
    "SensitivityProfile", "calibrate", "default_profile_path",
    "profile_key", "DEFAULT_BUDGETS", "OperatingPoint", "PrecisionLadder",
    "assign", "plan_ladder",
]

"""Accuracy-budget precision planner (adaptive precision serving, layer 2
of 3).

Counterpart of `repro/precision/planner.py`; `plan_ladder` compiles its
programs on `device` (CUDA by default).

Given a `SensitivityProfile` and a quality budget, assign each layer an
(r_in, r_w) point along the monotone `PRECISION_CHAIN` so the predicted
total quality delta stays within budget while the cheapest (fastest,
highest-POPS/W) points carry as many layers as possible.

The assignment is greedy with a budget-independent upgrade trajectory:
every layer starts at the cheapest point, and upgrades (layer -> next
chain rung) are applied in decreasing delta-reduction-per-extra-cost
order until the predicted delta fits the allowance.  Because the
trajectory itself never depends on the allowance - only the stopping
prefix does - assignments are *nested*: a stricter budget's assignment
dominates a looser budget's per layer (the monotonicity property the
tests pin).  Budgets are fractions of the profile's
worst-case delta (`max_total_delta`), so one budget dict works across
networks.

`plan_ladder` compiles each named budget into a `PrecisionLadder` of
`CIMProgram`s through the global keyed program cache - two ladders over
equal specs share plans and executables exactly like `BatchBuckets`
rungs - and attaches each operating point's perfmodel-projected time and
TOPS/W so `schedule_report`/fig22 can echo what was actually served.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import mapping
from repro_torch.precision.sensitivity import SensitivityProfile
from repro_torch.runtime import engine as rt
from repro_torch.runtime.program import (DEFAULT_BUCKETS, BatchBuckets,
                                         CIMProgram, Device, compile_program)

# quality-budget fractions of the profile's worst-case delta; insertion
# order is strictest first (the ladder report lists them in this order)
DEFAULT_BUDGETS: Dict[str, float] = {
    "quality": 0.02, "balanced": 0.2, "throughput": 0.6}


def _chain_cost(spec: mapping.LayerSpec, point: Tuple[int, int]) -> float:
    # bit-serial macro-eval proxy: r_in DP phases x r_w weight planes over
    # the layer's k x n cells - orders greedy upgrades; absolute time and
    # energy come from the compiled program's perf report afterwards
    return float(point[0] * point[1] * spec.m * spec.k * spec.n)


@dataclasses.dataclass(frozen=True)
class OperatingPoint:
    """One named rung of the precision ladder.

    `assignment[i]` is layer i's planned (r_in, r_w); `allowance` is the
    absolute logit-MSE budget the greedy assignment was stopped at
    (fraction x profile.max_total_delta) and `predicted_delta` the
    profile-additive delta of the final assignment (<= allowance unless
    even the all-base assignment exceeds it).  `predicted_time_s` /
    `predicted_tops_per_w` are perfmodel projections of the compiled
    programs."""
    name: str
    fraction: float
    allowance: float
    assignment: Tuple[Tuple[int, int], ...]
    predicted_delta: float
    predicted_time_s: float = 0.0
    predicted_tops_per_w: float = 0.0


def assign(profile: SensitivityProfile,
           specs: Sequence[mapping.LayerSpec],
           fraction: float) -> Tuple[Tuple[Tuple[int, int], ...], float]:
    """Greedy budgeted per-layer precision assignment.

    Returns (assignment, predicted_delta): each layer's (r_in, r_w) along
    `profile.points` plus the additive profile delta of the result.  The
    upgrade trajectory is independent of `fraction` (only the stopping
    point moves), so assignments nest monotonically across budgets."""
    specs = tuple(specs)
    if len(specs) != len(profile.layers):
        raise ValueError(
            f"profile covers {len(profile.layers)} layers, specs has "
            f"{len(specs)}")
    if not 0.0 <= fraction:
        raise ValueError(f"budget fraction must be >= 0, got {fraction}")
    chain = profile.points
    top = len(chain) - 1
    idx = [0] * len(specs)
    deltas = [profile.delta(i, chain[0]) for i in range(len(specs))]
    total = sum(deltas)
    allowance = float(fraction) * profile.max_total_delta()
    while total > allowance and any(j < top for j in idx):
        best, best_ratio = -1, None
        for i in range(len(specs)):
            if idx[i] >= top:
                continue
            nxt = chain[idx[i] + 1]
            gain = deltas[i] - profile.delta(i, nxt)
            cost = max(_chain_cost(specs[i], nxt)
                       - _chain_cost(specs[i], chain[idx[i]]), 1e-9)
            ratio = gain / cost
            if best_ratio is None or ratio > best_ratio:
                best, best_ratio = i, ratio
        idx[best] += 1
        new_d = profile.delta(best, chain[idx[best]])
        total += new_d - deltas[best]
        deltas[best] = new_d
    return tuple(chain[j] for j in idx), float(total)


@dataclasses.dataclass(frozen=True)
class PrecisionLadder:
    """A compiled ladder of named operating points over one network.

    `programs[name]` holds the point's compiled `CIMProgram`s - a single
    end-to-end program for chained specs, one single-layer program per
    layer for independent (non-chaining) specs.  All points share the
    global program cache, so equal (specs, cfg) rungs across ladders and
    across `BatchBuckets` reuse one plan each."""
    base_specs: Tuple[mapping.LayerSpec, ...]
    points: Tuple[OperatingPoint, ...]
    programs: Dict[str, Tuple[CIMProgram, ...]]
    chained: bool

    def names(self) -> Tuple[str, ...]:
        """The operating-point names, strictest budget first."""
        return tuple(op.name for op in self.points)

    def point(self, name: str) -> OperatingPoint:
        """The named OperatingPoint (ValueError on unknown names)."""
        for op in self.points:
            if op.name == name:
                return op
        raise ValueError(f"unknown operating point {name!r}; ladder has "
                         f"{list(self.names())}")

    def specs_for(self, name: str) -> Tuple[mapping.LayerSpec, ...]:
        """The per-layer LayerSpecs of one point (base specs re-tagged
        with the point's planned precisions)."""
        op = self.point(name)
        return tuple(
            dataclasses.replace(s, r_in=p[0], r_w=p[1])
            for s, p in zip(self.base_specs, op.assignment))

    def layer_programs(self, name: str) -> Tuple[CIMProgram, ...]:
        """The point's compiled programs (length 1 when chained)."""
        self.point(name)
        return self.programs[name]

    def program(self, name: str) -> CIMProgram:
        """The point's single chained program (ValueError for ladders
        over independent per-layer specs - use layer_programs)."""
        progs = self.layer_programs(name)
        if len(progs) != 1:
            raise ValueError(
                f"point {name!r} compiled {len(progs)} independent "
                "per-layer programs; use layer_programs()")
        return progs[0]

    def report(self) -> Dict[str, dict]:
        """Per-point summary for benchmarks/serving telemetry:
        {name: {assignment, allowance, predicted_delta, time_s,
        tops_per_w}}."""
        return {op.name: {
            "assignment": [list(p) for p in op.assignment],
            "allowance": op.allowance,
            "predicted_delta": op.predicted_delta,
            "time_s": op.predicted_time_s,
            "tops_per_w": op.predicted_tops_per_w,
        } for op in self.points}


def _point_perf(progs: Sequence[CIMProgram],
                name: str) -> Tuple[float, float]:
    total_s, total_j, ops_t = 0.0, 0.0, 0.0
    for prog in progs:
        tot = prog.perf_report(point=name)["total"]
        total_s += tot["time_s"]
        total_j += tot["energy_j"]
        ops_t += tot["tops"] * tot["time_s"]
    return total_s, (ops_t / total_j if total_j else 0.0)


def plan_ladder(profile: SensitivityProfile,
                specs: Sequence[mapping.LayerSpec],
                cfg: rt.EngineConfig = rt.EngineConfig(), *,
                budgets: Optional[Dict[str, float]] = None,
                activations: Optional[Sequence[str]] = None,
                pools: Optional[Sequence[int]] = None,
                buckets: BatchBuckets = DEFAULT_BUCKETS,
                device: Device = None) -> PrecisionLadder:
    """Plan and compile the full operating-point ladder of a network.

    For each named budget fraction (DEFAULT_BUDGETS by default): run the
    greedy `assign`, compile the resulting per-layer-precision specs
    through the global program cache (chained specs compile one
    end-to-end program; independent specs one program per layer), and
    attach the point's perfmodel-projected time and TOPS/W (the IMAGINE
    macro model's projection, not a measurement of `device`).  Points are
    ordered strictest-budget-first in the returned ladder.  The programs
    run on `device` (None means CUDA, as compile_program)."""
    specs = tuple(specs)
    budgets = dict(DEFAULT_BUDGETS if budgets is None else budgets)
    if not budgets:
        raise ValueError("plan_ladder needs at least one named budget")
    ordered = sorted(budgets.items(), key=lambda kv: (kv[1], kv[0]))
    points: List[OperatingPoint] = []
    programs: Dict[str, Tuple[CIMProgram, ...]] = {}
    for name, fraction in ordered:
        assignment, delta = assign(profile, specs, fraction)
        point_specs = tuple(
            dataclasses.replace(s, r_in=p[0], r_w=p[1])
            for s, p in zip(specs, assignment))
        if profile.chained:
            progs = (compile_program(point_specs, cfg,
                                     activations=activations, pools=pools,
                                     buckets=buckets, device=device),)
        else:
            progs = tuple(compile_program((ps,), cfg, buckets=buckets,
                                          device=device)
                          for ps in point_specs)
        time_s, tops_per_w = _point_perf(progs, name)
        points.append(OperatingPoint(
            name=str(name), fraction=float(fraction),
            allowance=float(fraction) * profile.max_total_delta(),
            assignment=assignment, predicted_delta=delta,
            predicted_time_s=time_s, predicted_tops_per_w=tops_per_w))
        programs[str(name)] = progs
    return PrecisionLadder(base_specs=specs, points=tuple(points),
                           programs=programs, chained=profile.chained)

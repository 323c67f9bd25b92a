"""Recompile-hazard pass (pass id ``recompile``).

Counterpart of `repro/analysis/recompile.py` over the port's dispatch
keys (`runtime/program.py` `executable_key`, `EXEC_KEY_FIELDS`).
`launch/serve.py --assert-no-recompile` catches new dispatch keys at run
time, after the damage; this pass bounds them at plan time.  On the card
a bound program captures one CUDA graph per *clean* key (no PRNG key, no
noise, not the reference, every partition on the program's device), so
the key set bounds the captures, their seconds and their graph-pool
memory.  Two checks:

  * **RC001** - the statically reachable key set (the `BatchBuckets`
    ladder x every operand-presence flag combination the program's
    config allows) must be finite and within budget.  The finding says
    how many CUDA graphs its clean keys could capture.
  * **RC002** - key-function sensitivity: perturbing any single
    `EXEC_KEY_FIELDS` field must change the produced key.  A key function
    that drops a field (e.g. forgets ``segmented``) aliases two dispatch
    signatures onto one key: a bound program would replay the graph of
    the other signature.
"""
from __future__ import annotations

import itertools
from typing import Callable, List, Optional, Sequence, Set

from repro_torch.analysis.findings import Finding, Report, Severity

PASS_ID = "recompile"

# a noise-enabled program reaches 24 flag combinations per ladder rung
# (noise x bound x reference x segmented x identity, key tied to noise);
# an 11-rung ladder (max_m=1024) is 264 keys per operating point, and a
# full precision ladder (base + quality/balanced/throughput) serves 4
# points = 1056 keys — budget leaves ~2x headroom over that
DEFAULT_KEY_BUDGET = 2048

# representative perturbation per EXEC_KEY_FIELDS field: (base, altered)
_FIELD_PROBES = {
    "kind": ("bucket", "exact"),
    "extent": (8, 16),
    "noise": (False, True),
    "keyed": (False, True),
    "devices": (1, 2),
    "bound": (False, True),
    "reference": (False, True),
    "segmented": (False, True),
    "identity": (False, True),
    "point": ("", "throughput"),
}

# the operating points a single-point program serves ("" = base); ladder
# checks pass the ladder's names explicitly
DEFAULT_POINTS = ("",)


def reachable_keys(buckets, max_m: int, *, devices: int,
                   noise_enabled: bool,
                   points: Sequence[str] = DEFAULT_POINTS) -> Set[tuple]:
    """Every executable key requests of extent 1..max_m can reach.

    Flag combinations follow the dispatch rules: a PRNG key travels with
    noise, identity ids only matter under noise, and bound/reference/
    segmented are free axes.  `points` enumerates the serving
    operating-point tags in play (the precision ladder multiplies the
    key set by its rung count; "" alone is the single-point default).
    """
    from repro_torch.runtime.program import executable_key
    keys: Set[tuple] = set()
    noise_opts = (False, True) if noise_enabled else (False,)
    for m in buckets.ladder(max_m):
        for noise, bound, reference, segmented in itertools.product(
                noise_opts, (False, True), (False, True), (False, True)):
            id_opts = (False, True) if noise else (False,)
            for identity in id_opts:
                for point in points:
                    keys.add(executable_key(
                        "bucket", m, noise=noise, keyed=noise,
                        devices=devices, bound=bound, reference=reference,
                        segmented=segmented, identity=identity,
                        point=point))
    return keys


def capturable_keys(keys: Set[tuple], *, one_device: bool = True
                    ) -> Set[tuple]:
    """The keys a bound program on the card captures a CUDA graph for:
    bound, no noise, no PRNG key, not the reference, and (for a sharded
    plan) every partition on the program's device (`one_device`)."""
    if not one_device:
        return set()
    from repro_torch.runtime.program import EXEC_KEY_FIELDS
    f = {name: i for i, name in enumerate(EXEC_KEY_FIELDS)}
    return {k for k in keys if k[f["bound"]] and not k[f["noise"]]
            and not k[f["keyed"]] and not k[f["reference"]]}


def check_key_budget(buckets, max_m: int, *, devices: int,
                     noise_enabled: bool,
                     budget: int = DEFAULT_KEY_BUDGET,
                     points: Sequence[str] = DEFAULT_POINTS,
                     one_device: bool = True) -> List[Finding]:
    """RC001: the reachable key set must be finite and within budget.
    `one_device`: whether every partition runs on the program's device
    (the condition for a CUDA graph)."""
    findings: List[Finding] = []
    ladder = buckets.ladder(max_m)
    if not ladder:
        findings.append(Finding(
            pass_id=PASS_ID, code="RC001", severity=Severity.ERROR,
            message=f"empty bucket ladder for max_m={max_m}; every request "
                    "extent would trace a fresh executable"))
        return findings
    # a sane ladder grows at most logarithmically (plus the cap grid)
    import math
    bound = int(math.log2(max(max_m, 1))) + 2
    if buckets.max_bucket:
        bound += -(-max_m // buckets.max_bucket)
    if len(ladder) > bound:
        findings.append(Finding(
            pass_id=PASS_ID, code="RC001", severity=Severity.ERROR,
            message=f"bucket ladder has {len(ladder)} rungs for "
                    f"max_m={max_m} (expected <= {bound}); the ladder is "
                    "not bounding the compile count"))
    keys = reachable_keys(buckets, max_m, devices=devices,
                          noise_enabled=noise_enabled, points=points)
    n = len(keys)
    if n > budget:
        graphs = len(capturable_keys(keys, one_device=one_device))
        findings.append(Finding(
            pass_id=PASS_ID, code="RC001", severity=Severity.ERROR,
            message=f"{n} statically-reachable executable keys exceed the "
                    f"budget of {budget}; steady-state serving would keep "
                    f"dispatching new keys, and the {graphs} clean keys "
                    f"among them could capture {graphs} CUDA graphs a "
                    "bound program on the card"))
    return findings


def check_key_sensitivity(key_fn: Optional[Callable] = None, *,
                          fields: Sequence[str] = ()) -> List[Finding]:
    """RC002: every key field must be discriminated by the key function.

    ``key_fn(kind, extent, **flags)`` defaults to the runtime's real
    `executable_key`; ``fields`` defaults to `EXEC_KEY_FIELDS`.
    """
    from repro_torch.runtime import program as prog_mod
    if key_fn is None:
        key_fn = prog_mod.executable_key
    if not fields:
        fields = prog_mod.EXEC_KEY_FIELDS
    base_kw = {f: probes[0] for f, probes in _FIELD_PROBES.items()
               if f not in ("kind", "extent")}
    findings: List[Finding] = []

    def call(kind, extent, kw):
        return key_fn(kind, extent, **kw)

    base = call(_FIELD_PROBES["kind"][0], _FIELD_PROBES["extent"][0],
                base_kw)
    for field in fields:
        if field not in _FIELD_PROBES:
            findings.append(Finding(
                pass_id=PASS_ID, code="RC002", severity=Severity.ERROR,
                message=f"no perturbation probe for key field {field!r}; "
                        "extend recompile._FIELD_PROBES alongside "
                        "EXEC_KEY_FIELDS"))
            continue
        kind = (_FIELD_PROBES["kind"][1] if field == "kind"
                else _FIELD_PROBES["kind"][0])
        extent = (_FIELD_PROBES["extent"][1] if field == "extent"
                  else _FIELD_PROBES["extent"][0])
        kw = dict(base_kw)
        if field not in ("kind", "extent"):
            kw[field] = _FIELD_PROBES[field][1]
        if call(kind, extent, kw) == base:
            findings.append(Finding(
                pass_id=PASS_ID, code="RC002", severity=Severity.ERROR,
                message=f"executable cache key ignores the {field!r} "
                        "field: two different dispatch signatures alias one "
                        "dispatch key, and a bound program would replay the "
                        "graph of the other signature"))
    return findings


def _graphable(program) -> bool:
    """Whether the program's clean dispatches can be CUDA graphs: every
    partition on its device (False where the placement cannot hold the
    plan's mesh at all)."""
    try:
        return program._on_one_device()
    except ValueError:
        return False


def run(program, *, max_m: int = 1024,
        budget: int = DEFAULT_KEY_BUDGET,
        points: Sequence[str] = DEFAULT_POINTS) -> Report:
    """Run both recompile checks against a compiled `CIMProgram` (its
    own device decides whether a sharded plan's dispatches are graphs).

    `points` lists the serving operating-point tags the program will be
    dispatched under (the precision ladder's names plus "" for the base
    point) — RC001 budgets the key set they multiply into."""
    report = Report()
    plan = program.plan
    devices = (plan.cfg.sharding.resolve_devices()
               if plan.cfg.sharding is not None else 1)
    report.extend(check_key_budget(
        program.buckets, max_m, devices=devices,
        noise_enabled=plan.cfg.noise.enabled, budget=budget,
        points=points, one_device=_graphable(program)))
    report.extend(check_key_sensitivity())
    return report

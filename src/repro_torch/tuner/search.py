"""Plan-time schedule search: score every candidate, keep the winner.

Counterpart of `repro/tuner/search.py`.  `tune_network` is the tuner's
entry point (what `runtime.program.compile_program(tune=...)` calls): for
each layer it enumerates the tiles the layer's dispatch may run
(`kernels.cim_mbiw.ops.block_candidates`: every legal tile of the route
`route_for` takes at the launch the engine makes, one row tile deep over
the whole padded width) crossed, on a multi-device plan, with the two
shard kinds (a "rows" partition launches ceil(M / D) rows, a "col"
partition its tiles_per_device col tiles, so its tiles are those of
that shape), scores each with `cost.layer_cost`, and keeps the
strict-best - the heuristic candidate (`route_for`'s own tile) is scored FIRST, so the tuned
schedule's analytic cost is <= the heuristic's by construction.  In
"measure" mode the analytic top-k candidates are additionally timed on
the card with CUDA events (a captured graph of many launches of the tile
on seeded synthetic data, min of repeats) and the fastest measured one
wins; a program on the CPU cannot be measured (its plain version ignores
tiles), and asking raises.

Winners that exactly match the heuristic fold to `None` in the schedule
handed to `plan_network`, so a no-win layer produces a plan that hashes
(and caches) identically to the untuned one.

`SEARCH_COUNT` counts layers actually searched (cache hits skip it) -
the tuner-side mirror of `engine.PLAN_COUNT`.

Tuning is numerics-neutral end to end: a tile only changes where the
exact int32 sums are taken (route B's chunk sums are associative), so the
search is free to chase the roofline without a single output bit moving.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import mapping
from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO
from repro_torch.kernels.cim_mbiw import kernel as kmod
from repro_torch.kernels.cim_mbiw import ops as kops
from repro_torch.tuner import cache as tcache
from repro_torch.tuner.cost import LayerCost, ScheduleChoice, layer_cost

# layers searched (cache misses that ran the candidate scan); a cache hit
# or a degraded/invalid cache entry does NOT increment it
SEARCH_COUNT = {"n": 0}

MEASURE_TOP_K = 3       # candidates timed in "measure" mode
_MEASURE_ITERS = 3      # timing repeats (min taken)
# launches of one candidate captured in one graph and replayed between
# two events: a short tile's own time, not the host's launch rate
_MEASURE_LAUNCHES = 20

MODES = ("analytic", "measure")


def _dispatch(spec: mapping.LayerSpec, macro: CIMMacroConfig,
              devices: int = 1,
              kind: Optional[str] = None) -> Tuple[int, int, int, int]:
    """(rows, k, n, planes) of one kernel launch the engine makes for the
    layer (one a row tile, `engine.NetworkPlan.tile_calls`): `spec.m`
    rows, one row tile deep, over every col tile of the padded width; on
    `devices` > 1 one partition's launch under `kind` (None: the
    automatic kind), a "rows" partition's ceil(M / D) rows or a "col"
    partition's tiles_per_device col tiles."""
    mp = mapping.map_layer(spec, macro)
    rows, tiles = spec.m, mp.col_tiles
    if devices > 1:
        sh = mapping.shard_layer(spec, mp, devices, kind=kind)
        if sh.kind == "rows":
            rows = sh.rows_per_device
        else:
            tiles = sh.tiles_per_device
    return (rows, mp.rows_per_tile, tiles * math.ceil(spec.n / mp.col_tiles),
            kmod.plane_layout(spec.r_in)[1])


def heuristic_choice(spec: mapping.LayerSpec, cfg,
                     macro: CIMMacroConfig = DEFAULT_MACRO) -> ScheduleChoice:
    """The schedule the engine runs untuned: `route_for`'s own tile at the
    launch the engine makes for `spec.m` rows, on the devices of `cfg`'s
    sharding under the automatic kind (`cfg` is read for nothing else on
    the card: its Pallas block sizes change no launch)."""
    sharding = getattr(cfg, "sharding", None)
    devices = sharding.resolve_devices() if sharding is not None else 1
    rows, k, n, planes = _dispatch(spec, macro, devices)
    return ScheduleChoice(*kmod.route_for(rows, n, k, planes).tile)


def layer_candidates(spec: mapping.LayerSpec, cfg, devices: int,
                     macro: CIMMacroConfig = DEFAULT_MACRO
                     ) -> List[ScheduleChoice]:
    """Every candidate the search scores for one layer, heuristic first.

    Tiles are the legal tiles of the dispatch's route at the rows a
    partition dispatches; shard kinds are {None} on one device and the
    automatic kind first, then the other "col"/"rows", on a multi-device
    plan.  Deduplicated, order-stable."""
    mp = mapping.map_layer(spec, macro)
    if devices <= 1:
        kinds: Tuple[Optional[str], ...] = (None,)
    else:
        auto = "col" if mp.col_tiles >= devices else "rows"
        kinds = (auto, "rows" if auto == "col" else "col")
    out = [heuristic_choice(spec, cfg, macro)]
    seen = {out[0]}
    for kind in kinds:
        rows, k, n, planes = _dispatch(spec, macro, devices, kind)
        for tile in kops.block_candidates(rows, k, n, planes):
            c = ScheduleChoice(*tile, shard_kind=kind)
            if c not in seen:
                seen.add(c)
                out.append(c)
    return out


def _measure_choice_s(spec: mapping.LayerSpec, choice: ScheduleChoice,
                      macro: CIMMacroConfig, device: torch.device,
                      devices: int = 1) -> float:
    """Seconds one launch of the candidate's tile takes on the card, on
    seeded synthetic data for one launch the engine makes (a partition's
    where the choice shards, `_dispatch`): `_MEASURE_LAUNCHES`
    launches captured in a CUDA graph (after an eager warm-up, which also grows
    route B's workspace outside the capture), replayed between CUDA
    events, min of `_MEASURE_ITERS`.  Forced through `kernel.launch`,
    which counts nothing.  Used only for ranking - never for numerics."""
    rows, k, n, planes = _dispatch(spec, macro, devices, choice.shard_kind)
    shift, _ = kmod.plane_layout(spec.r_in)
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2 ** min(shift, spec.r_in), (rows, planes * k),
                     dtype=np.int8)
    half = 2 ** (spec.r_w - 1)
    w = (2 * rng.integers(-half, half, (k, n)) + 1).astype(np.int8)
    args = [torch.from_numpy(a).to(device) for a in (
        x, w, np.ones((1, n), np.float32), np.zeros((1, n), np.float32))]
    out = torch.empty((rows, n), dtype=torch.int32, device=device)
    route = kmod.route_for(rows, n, k, planes, choice.blocks)

    def run():
        kmod.launch(route, *args, out, plane_shift=shift, g0=1.0,
                    r_out=spec.r_out, fuse_adc=True)
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        run()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(_MEASURE_LAUNCHES):
            run()
    graph.replay()
    best = float("inf")
    for _ in range(_MEASURE_ITERS):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        best = min(best, 1e-3 * t0.elapsed_time(t1) / _MEASURE_LAUNCHES)
    return best


def tune_layer(spec: mapping.LayerSpec, cfg, devices: int, *,
               mode: str = "analytic",
               cache: Optional[tcache.TuneCache] = None,
               macro: CIMMacroConfig = DEFAULT_MACRO,
               device: Optional[torch.device] = None,
               folded: bool = False) -> Tuple[ScheduleChoice, dict]:
    """Pick one layer's schedule: cache hit -> stored winner (no search);
    miss -> full candidate scan (SEARCH_COUNT += 1) + write-back;
    invalid/degraded cache entry -> heuristic with the cache's warning.
    `device` is the card "measure" mode times on; `folded` prices the
    `devices` partitions on one card (`cost.layer_cost`).

    Returns (choice, report); the report echoes the cache status, the
    heuristic and tuned analytic costs, the candidate count and, in
    "measure" mode, the seconds a launch each timed candidate took
    (`measured_s`, keyed by tile)."""
    heur = heuristic_choice(spec, cfg, macro)
    heur_cost = layer_cost(spec, heur, devices=devices, macro=macro,
                           folded=folded)
    key = tcache.cache_key(spec, devices, macro, folded=folded)
    report = {"key": key, "mode": mode, "heuristic": heur,
              "heuristic_s": heur_cost.total_s}

    status = tcache.MISS
    if cache is not None:
        status, cached = cache.get(key, kmod.plane_layout(spec.r_in)[1])
        if status == tcache.HIT:
            c_cost = layer_cost(spec, cached, devices=devices, macro=macro,
                                folded=folded)
            report.update(cache=tcache.HIT, choice=cached,
                          predicted_s=c_cost.total_s, candidates=0)
            return cached, report
        if status == tcache.INVALID:
            report.update(cache=tcache.INVALID, choice=heur,
                          predicted_s=heur_cost.total_s, candidates=0)
            return heur, report

    SEARCH_COUNT["n"] += 1
    cands = layer_candidates(spec, cfg, devices, macro)
    scored: List[Tuple[LayerCost, ScheduleChoice]] = [
        (layer_cost(spec, c, devices=devices, macro=macro,
                    folded=folded), c)
        for c in cands]
    best_cost, best = scored[0]        # the heuristic - ties keep it
    for lc, c in scored[1:]:
        if lc.score() < best_cost.score():
            best_cost, best = lc, c

    if mode == "measure":
        ranked = sorted(scored, key=lambda sc: sc[0].score())
        timed = [(_measure_choice_s(spec, c, macro, device, devices), lc,
                  c)
                 for lc, c in ranked[:MEASURE_TOP_K]]
        _, best_cost, best = min(timed, key=lambda t: t[0])
        report["measured_s"] = {c.blocks: t for t, _, c in timed}

    if cache is not None:
        cache.put(key, best, mode=mode, total_s=best_cost.total_s)
    report.update(cache=status, choice=best,
                  predicted_s=best_cost.total_s, candidates=len(cands))
    return best, report


def _fold(choice: ScheduleChoice, heur: ScheduleChoice
          ) -> Optional[Tuple[kmod.Tile, Optional[str]]]:
    """Collapse a no-win choice to None so the tuned plan hashes (and
    program-caches) identically to the heuristic plan."""
    if choice == heur:
        return None
    return (choice.blocks, choice.shard_kind)


def tune_network(specs: Sequence[mapping.LayerSpec], cfg,
                 activations: Optional[Sequence[str]] = None,
                 pools: Optional[Sequence[int]] = None, *,
                 mode: str = "analytic",
                 cache_path: Optional[str] = None,
                 device=None):
    """Tune every layer and build the (single PLAN_COUNT) tuned plan.

    Returns (NetworkPlan, reports): the plan comes from one
    `engine.plan_network(..., schedule=...)` call with no-win layers
    folded to None, and `reports` is the per-layer tune_layer echo list
    (consumed by `perfmodel.macro_perf.schedule_report`).  Passing
    cache_path="" disables the persistent cache entirely.  `device` is
    where the program runs (None: CUDA); "measure" mode needs a CUDA
    device and raises ValueError on any other."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dev = torch.device("cuda" if device is None else device)
    if mode == "measure" and dev.type != "cuda":
        raise ValueError(
            f'tune="measure" times the Hopper kernel on the card; the '
            f"plain version a {dev.type} program runs ignores tiles, so "
            'there is nothing to measure (use tune="analytic")')
    from repro_torch.runtime import engine  # avoid a module-load cycle

    sharding = getattr(cfg, "sharding", None)
    devices = sharding.resolve_devices() if sharding is not None else 1
    folded = sharding is not None and sharding.fold_onto is not None
    macro = getattr(cfg, "macro", DEFAULT_MACRO)
    cache = None
    if cache_path != "":
        path = cache_path or tcache.default_cache_path()
        cache = tcache.TuneCache.load(path)

    schedule, reports = [], []
    wrote = False
    for spec in specs:
        choice, rep = tune_layer(spec, cfg, devices, mode=mode,
                                 cache=cache, macro=macro, device=dev,
                                 folded=folded)
        wrote = wrote or rep.get("cache") == tcache.MISS
        schedule.append(_fold(choice, rep["heuristic"]))
        reports.append(rep)
    if cache is not None and wrote:
        cache.save()

    plan = engine.plan_network(specs, cfg, activations, pools,
                               schedule=tuple(schedule))
    return plan, reports

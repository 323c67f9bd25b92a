"""The arithmetic of the per-layer metrics that read the program's own
spans (`repro_torch.runtime.tracing`, recorded while the traced window's
profiler runs) and its set-up counters (`engine.CAPTURE_COUNT["s"]`,
`engine.BIND_COUNT["s"]`, host seconds).

A program that lacks them (an older checkout) has nothing to read: each
function then gives None and raises nothing.  So does a run whose
tracer dropped records.
"""
from __future__ import annotations

import statistics
from typing import List, Optional


def window_spans(ctx, name: str) -> Optional[List]:
    """The records of the spans called `name` that lie inside the run's
    window, on `perf_counter_ns` (None where the program records no
    spans, or dropped some)."""
    try:
        from repro_torch.runtime import tracing
    except ImportError:
        return None
    if tracing.dropped() or ctx.t_window is None:
        return None
    lo = round(ctx.t_window * 1e9)
    hi = lo + round(ctx.window_s * 1e9)
    return [r for r in tracing.records()
            if r.name == name and lo <= r.t0_ns and r.t1_ns <= hi]


def median_ms(ctx, name: str, **attrs) -> Optional[float]:
    """Median host milliseconds of the window's spans `name` whose
    attributes hold `attrs`."""
    recs = window_spans(ctx, name) or []
    ms = [1e-6 * (r.t1_ns - r.t0_ns) for r in recs
          if all(r.attrs.get(k) == v for k, v in attrs.items())]
    return statistics.median(ms) if ms else None


def slot_occupancy_pct(ctx) -> Optional[float]:
    """100 * sum of live slots over sum of slots, over the window's fused
    decode steps ("serve.decode_step")."""
    recs = window_spans(ctx, "serve.decode_step") or []
    slots = sum(r.attrs["slots"] for r in recs)
    return 100.0 * sum(r.attrs["live"] for r in recs) / slots if slots \
        else None


def setup_pct(ctx, counter: str) -> Optional[float]:
    """The host seconds in `engine.<counter>["s"]` as a share of set-up
    (process start to the window), percent.  The counter is read after
    the run; it holds set-up's alone where the window bound and captured
    nothing (the growth of `captures` and `binds` is 0), and otherwise
    nothing is read."""
    from repro_torch.runtime import engine
    seconds = getattr(engine, counter, {}).get("s")
    grown = ctx.counters.get("captures", 0) or ctx.counters.get("binds", 0)
    if seconds is None or grown or ctx.t_window is None:
        return None
    return 100.0 * seconds / (ctx.t_window - ctx.t_start)

"""The program's own counters, read before and after the window."""
from __future__ import annotations

from typing import Dict


def snapshot() -> Dict[str, int]:
    """Dispatches of the live programs by route, CUDA graph captures,
    plans and weight binds."""
    from repro_torch.runtime import engine, program
    d = program.dispatch_stats()
    d["captures"] = engine.CAPTURE_COUNT["n"]
    d["plans"] = engine.PLAN_COUNT["n"]
    d["binds"] = program.bound_cache_stats()["binds"]
    return d


def growth(before: Dict[str, int]) -> Dict[str, int]:
    now = snapshot()
    return {k: now[k] - before[k] for k in now}

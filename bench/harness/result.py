"""The result line of a run."""
from __future__ import annotations

from typing import Dict

from bench.harness.context import Context


def end_to_end(ctx: Context) -> Dict[str, float]:
    """The cell's end-to-end metrics: what the driver measured, set-up
    (process start to the first timed call) and the memory peak."""
    vals = dict(ctx.e2e)
    vals["setup_s"] = ctx.t_window - ctx.t_start
    vals["peak_mem_gib"] = ctx.memory_peak_bytes / 2.0 ** 30
    return vals


def assemble(ctx: Context, readers: Dict, device_name: str,
             power_limit: str) -> Dict:
    """{correct, attempted, failed, metrics, device[, breakdown], checks}:
    with a trace the per-layer metrics (a reader that finds nothing to
    read is left out), otherwise the end-to-end ones.  Correct: every
    check within its limit and no attempt failed."""
    metrics = {}
    if ctx.tracing:
        for m in ctx.cell.per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = end_to_end(ctx)
        for m in ctx.cell.end_to_end:
            if m["name"] in vals:
                metrics[m["name"]] = {"value": vals[m["name"]],
                                      "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name,
              "count": ctx.cell.chips,
              "memory_peak_bytes": ctx.memory_peak_bytes,
              "power_limit_w": power_limit}
    correct = bool(ctx.checks) and all(c.ok for c in ctx.checks) \
        and ctx.failed == 0
    out = {"correct": correct,
           "attempted": ctx.attempted, "failed": ctx.failed,
           "metrics": metrics, "device": device}
    if ctx.tracing and ctx.trace:
        device["busy_s"] = ctx.trace["busy_s"]
        device["window_s"] = ctx.trace["window_s"]
        out["breakdown"] = {"device_ops": ctx.trace["device_ops"],
                            "idle_gaps": ctx.trace["idle_gaps"]}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in ctx.checks}
    return out

"""The arithmetic of the per-layer metrics that several cells read under
names of their own (`bench/metrics/<name>.py` picks one): each takes a
run's context and gives a value, or None where the run holds nothing to
read."""
from __future__ import annotations

from bench.harness import trace


def eager_dispatch_pct(ctx):
    """Eager dispatches over all dispatches of the window's compiled
    programs, in percent (`program.dispatch_stats()` growth)."""
    c = ctx.counters
    total = c.get("eager_calls", 0) + c.get("graph_replays", 0) \
        + c.get("graphs_captured", 0)
    return 100.0 * c.get("eager_calls", 0) / total if total else None


def glue_device_pct(ctx):
    """Device time of every operation that is not a port kernel, as a
    share of the traced window (percent)."""
    t = ctx.trace
    if not t:
        return None
    return 100.0 * trace.glue_seconds(t["kernels"]) / t["window_s"]


def cim_mbiw_roofline(ctx):
    """The least time of the window's engine-mode products (the frozen
    `costs.cim_mbiw` once per layer at the network's shapes) over the
    device time of every cim_mbiw launch, on all routes (percent)."""
    t = ctx.trace
    if not t or ctx.work is None:
        return None
    dev = trace.port_kernel_seconds(t["kernels"], "cim_mbiw")
    return 100.0 * ctx.work.cim_bound_s() / dev if dev > 0 else None


def device_idle_pct(ctx):
    """Share of the traced window in which no operation ran on the
    device (percent)."""
    t = ctx.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None


def mfu(ctx):
    """The network's products over the window, each at its type's peak
    (CIM-mapped at int8, the rest at bf16 or float32), as a share of the
    traced window (percent)."""
    t = ctx.trace
    if not t or ctx.work is None or not ctx.work.ops:
        return None
    return 100.0 * ctx.work.peak_s() / t["window_s"]

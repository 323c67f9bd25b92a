"""Spans the benchmark records around its calls into the program, and
the reduction of one traced window's device timeline.

Spans are host `perf_counter` intervals, kept in memory.  In a traced
run each span is also a `torch.profiler.record_function` range, so the
profiler's timeline holds it beside the device's operations, in one
clock.  The reduction reads only that timeline: the window's length,
the union of device activity within it, the device time of each
operation, and what the host was doing in the longest idle gaps.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

# device operations that are the port's own kernels, by a part of their
# name; every other device operation is glue
PORT_KERNELS = ("cim_mbiw", "threefry_normal", "flash_", "ring_decode")
WINDOW = "bench.window"


class Spans:
    """Named host intervals; each is also a profiler range when
    `tracing`."""

    def __init__(self, tracing: bool = False):
        self.tracing = tracing
        self.items: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.tracing:
            import torch
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if rf is not None:
                rf.__exit__(None, None, None)
            self.items.append((name, t0, t1))

    def durations(self, name: str) -> List[float]:
        """Seconds of every span called `name`, in order."""
        return [t1 - t0 for n, t0, t1 in self.items if n == name]


class Profiler:
    """The profiler over the host and the device, through its low-level
    entry points: the timeline's events come back as recorded, without
    the per-event Python objects `torch.profiler.profile` builds at its
    exit (minutes for a window of a million events)."""

    def __enter__(self):
        from torch.autograd import (ProfilerConfig, ProfilerState,
                                    _enable_profiler, _prepare_profiler)
        from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
        self.cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                                  False, False, _ExperimentalConfig())
        self.acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        _prepare_profiler(self.cfg, self.acts)
        _enable_profiler(self.cfg, self.acts)
        self.result = None
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler
        self.result = _disable_profiler()
        return False


def _events(result):
    """(device events, host events) as lists of (name, start_ns, end_ns)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in result.events():
        s = e.start_ns()
        rec = (e.name(), s, s + e.duration_ns())
        if e.device_type() == cuda:
            # a host range's copy on the device timeline is no device work
            if not e.is_user_annotation():
                dev.append(rec)
        else:
            host.append(rec)
    return dev, host


def _union(iv: np.ndarray) -> float:
    """Total length of the union of intervals (N, 2)."""
    if len(iv) == 0:
        return 0.0
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    starts = iv[:, 0]
    # a new run starts where an interval begins after every earlier end
    new = np.ones(len(iv), dtype=bool)
    new[1:] = starts[1:] > ends[:-1]
    run_id = np.cumsum(new) - 1
    run_start = starts[new]
    run_end = np.zeros(run_id[-1] + 1)
    np.maximum.at(run_end, run_id, iv[:, 1])
    return float(np.sum(run_end - run_start))


def reduce(result, span_names) -> Dict:
    """The traced window's numbers: window_s, busy_s (device activity
    within the window, a union), kernels {name: device seconds}, and the
    breakdown's lists (the 10 device operations of most time, and the
    idle gaps by what the host was doing, over the 200 longest gaps)."""
    dev, host = _events(result)
    names = set(span_names) | {WINDOW}
    win = [h for h in host if h[0] == WINDOW]
    if not win:
        return {}
    w0, w1 = win[0][1], win[0][2]
    # device-side copies of the host ranges are not device work
    ops = [d for d in dev if d[0] not in names and d[2] > w0 and d[1] < w1]
    if not ops:
        return {}
    iv = np.array([[max(s, w0), min(e, w1)] for _, s, e in ops],
                  dtype=np.float64)
    busy = _union(iv) * 1e-9
    kernels: Dict[str, float] = {}
    for n, s, e in ops:
        kernels[n] = kernels.get(n, 0.0) + (min(e, w1) - max(s, w0)) * 1e-9
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy,
            "kernels": kernels, "device_ops": [[n, v] for n, v in top],
            "idle_gaps": _gaps(iv, host, names, w0, w1)}


def _gaps(iv: np.ndarray, host, spans, w0: int, w1: int,
          longest: int = 200) -> List[list]:
    """Idle time of the 200 longest device gaps in the window, summed by
    what the host was doing at each gap's middle: the innermost span of
    the benchmark and the innermost host operation."""
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    g0 = np.concatenate([[w0], ends])
    g1 = np.concatenate([iv[:, 0], [w1]])
    length = g1 - g0
    keep = np.argsort(-length)[:longest]
    keep = keep[length[keep] > 0]
    hs = np.array([h[1] for h in host], dtype=np.float64)
    he = np.array([h[2] for h in host], dtype=np.float64)
    is_span = np.array([h[0] in spans and h[0] != WINDOW for h in host])
    out: Dict[str, float] = {}
    for i in keep:
        mid = 0.5 * (g0[i] + g1[i])
        cover = (hs <= mid) & (he >= mid)
        name = "idle"
        sp = np.flatnonzero(cover & is_span)
        op = np.flatnonzero(cover & ~is_span & (he - hs > 0))
        parts = []
        if len(sp):
            parts.append(host[sp[np.argmax(hs[sp])]][0])
        if len(op):
            parts.append(host[op[np.argmax(hs[op])]][0])
        if parts:
            name = "/".join(parts)
        out[name] = out.get(name, 0.0) + length[i] * 1e-9
    return [[n, v] for n, v in sorted(out.items(), key=lambda kv: -kv[1])[:10]]


def port_kernel_seconds(kernels: Dict[str, float],
                        part: Optional[str] = None) -> float:
    """Device seconds of the port's kernels (those whose name holds
    `part`, or any of PORT_KERNELS)."""
    parts = (part,) if part else PORT_KERNELS
    return sum(v for n, v in kernels.items() if any(p in n for p in parts))


def glue_seconds(kernels: Dict[str, float]) -> float:
    """Device seconds of every operation that is not a port kernel."""
    return sum(v for n, v in kernels.items()
               if not any(p in n for p in PORT_KERNELS))

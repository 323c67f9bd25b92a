"""What a traffic kind's driver is handed, and what it hands back."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

from bench.harness import trace as tr
from bench.harness.manifest import Cell


@dataclasses.dataclass
class Check:
    """One number compared, with its limit (correct when value <= limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclasses.dataclass
class Context:
    """A run of one cell: its files, the seed, the window's length, the
    device, the spans, and the process's start on the host clock.  A
    driver fills the `record` fields."""
    cell: Cell
    seed: int
    seconds: float
    tracing: bool
    device: object
    t_start: float
    control: bool = False
    spans: tr.Spans = None
    # filled by the driver
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: List[Check] = dataclasses.field(default_factory=list)
    notes: Dict[str, float] = dataclasses.field(default_factory=dict)
    memory_peak_bytes: int = 0
    t_window: Optional[float] = None
    window_s: float = 0.0
    trace: Dict = dataclasses.field(default_factory=dict)
    # what the window ran, for the per-layer readers: counters, the
    # entry's own returns, and the work (`work.Work`)
    counters: Dict[str, float] = dataclasses.field(default_factory=dict)
    entry: Dict[str, float] = dataclasses.field(default_factory=dict)
    work: object = None

    def __post_init__(self):
        if self.spans is None:
            self.spans = tr.Spans(self.tracing)

    @contextlib.contextmanager
    def window(self):
        """The measured window: timed on the host clock and, in a traced
        run, under the profiler (its reduction, after the window, lands
        in `trace`)."""
        prof = tr.Profiler() if self.tracing else contextlib.nullcontext()
        with prof:
            self.t_window = time.perf_counter()
            with self.spans.span(tr.WINDOW):
                yield
                self.sync()
            self.window_s = time.perf_counter() - self.t_window
        if self.tracing:
            t0 = time.perf_counter()
            names = {n for n, _, _ in self.spans.items}
            self.trace = tr.reduce(prof.result, names)
            self.notes["trace_reduce_s"] = time.perf_counter() - t0

    def sync(self) -> None:
        import torch
        if getattr(self.device, "type", "cpu") == "cuda":
            torch.cuda.synchronize(self.device)

    def read_peak(self) -> None:
        """The peak of device memory over set-up and window; read before
        the reference runs."""
        import torch
        if getattr(self.device, "type", "cpu") == "cuda":
            self.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(self.device))

    def elapsed(self) -> float:
        return time.perf_counter() - self.t_window

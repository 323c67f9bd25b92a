"""Host spans of the port, recorded only while a torch profiler runs.

    with tracing.span("serve.prefill", uid=7, prompt_len=130):
        ...
    tracing.records()     # [Record(span_id, parent_id, name, t0_ns, ...)]

A span is a host interval on `time.perf_counter_ns()` and, while it is
open, a `torch.profiler.record_function` range of the same name, so the
profiler's timeline holds it beside the device's operations.  Its
parent is the span open around it when it began (one stack for the
process: the serving loop is single-threaded), and the spans of one
request carry its `uid` in `attrs`.

Recording is on exactly while a profiler runs
(`torch._C._autograd._profiler_enabled()`, a check of about 0.2 us),
under `torch.profiler.profile` or the low-level `_enable_profiler`
alike.  Otherwise `span` returns one shared object whose enter and exit
do nothing: no record is kept and no `record_function` is made (one
costs about 11 us even with no profiler running).  There is no other
switch.

Records stay in memory, the first `CAPACITY` of them; `dropped()`
counts those that did not fit.  `clear()` empties both.  Set-up's
captures and binds are timed in the counters beside their counts
(`engine.CAPTURE_COUNT["s"]`, `engine.BIND_COUNT["s"]`), always.
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, NamedTuple, Optional

import torch

CAPACITY = 1 << 20


class Record(NamedTuple):
    """One closed span: perf_counter_ns times, parent None at the root."""
    span_id: int
    parent_id: Optional[int]
    name: str
    t0_ns: int
    t1_ns: int
    attrs: Dict


_RECORDS: List[Record] = []
_STACK: List[int] = []
_IDS = itertools.count(1)
_DROPPED = [0]
_profiler_enabled = torch._C._autograd._profiler_enabled


class _Off:
    """The span while no profiler runs."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **attrs) -> None:
        pass


OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "span_id", "parent_id", "t0", "_range")

    def __init__(self, name: str, attrs: Dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        self.parent_id = _STACK[-1] if _STACK else None
        self.span_id = next(_IDS)
        _STACK.append(self.span_id)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._range.__exit__(None, None, None)
        _STACK.pop()
        if len(_RECORDS) < CAPACITY:
            _RECORDS.append(Record(self.span_id, self.parent_id, self.name,
                                   self.t0, t1, self.attrs))
        else:
            _DROPPED[0] += 1
        return False

    def annotate(self, **attrs) -> None:
        """Add attributes known only once the span is open."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager over one span `name` with `attrs`; a no-op
    unless a profiler runs."""
    if not _profiler_enabled():
        return OFF
    return _Span(name, attrs)


def records() -> List[Record]:
    """The kept records, in the order their spans closed."""
    return list(_RECORDS)


def dropped() -> int:
    """Records that did not fit in `CAPACITY` since the last clear."""
    return _DROPPED[0]


def clear() -> None:
    _RECORDS.clear()
    _DROPPED[0] = 0

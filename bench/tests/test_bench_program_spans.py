"""The readers of the program's own spans and set-up counters
(`harness/program_spans.py`): each tiny cell, traced on the CPU, reports
every one of its metrics that the CPU can show; and over a program
without the tracer or the counters' seconds (an older checkout) each
reader gives None and raises nothing.
"""
from __future__ import annotations

import sys

import pytest
import torch

from bench.harness import manifest, program_spans
from bench.harness.result import assemble
from bench.tests.cpu import run_cpu, tiny_cell
from bench.tests.test_bench_control import TINY

NEW = {"prefill_ms.tokens", "decode_enqueue_ms.tokens",
       "slot_occupancy_pct.tokens", "dispatch_host_ms.images",
       "capture_setup_pct.setup", "bind_setup_pct.setup"}
# every dispatch on the host is eager: no graph replay to read
CARD_ONLY = {"dispatch_host_ms.images"}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def traced(name, monkeypatch):
    """A traced tiny run of cell `name`, its set-up counters from zero as
    in a fresh process; (context, metrics of the result line)."""
    from repro_torch.runtime import engine
    for counter in (engine.CAPTURE_COUNT, engine.BIND_COUNT):
        monkeypatch.setitem(counter, "s", 0.0)
    conf, mix = TINY[name]
    cell = tiny_cell(name, conf, mix)
    ctx = run_cpu(cell, seed=2 ** 31 + 23, tracing=True)
    readers = {m["name"]: manifest.metric_reader(m["name"])
               for m in cell.per_layer}
    res = assemble(ctx, readers, "cpu", "")
    assert res["correct"]
    return ctx, res["metrics"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_traced_tiny_cell_reports_the_program_metrics(name, monkeypatch):
    ctx, metrics = traced(name, monkeypatch)
    mine = {m["name"] for m in manifest.cell(name).per_layer} & NEW
    assert mine
    assert mine - CARD_ONLY <= set(metrics), sorted(metrics)
    assert metrics["capture_setup_pct.setup"]["value"] == 0.0
    assert 0.0 < metrics["bind_setup_pct.setup"]["value"] < 100.0
    if "slot_occupancy_pct.tokens" in mine:
        assert 0.0 < metrics["slot_occupancy_pct.tokens"]["value"] <= 100.0
        assert metrics["prefill_ms.tokens"]["value"] > 0.0
        assert metrics["decode_enqueue_ms.tokens"]["value"] > 0.0
        steps = program_spans.window_spans(ctx, "serve.decode_step")
        assert len(steps) == ctx.entry["decode_steps"]
    else:
        assert "dispatch_host_ms.images" not in metrics
        assert program_spans.median_ms(ctx, "program.dispatch",
                                       route="eager") > 0.0


def test_spans_outside_the_window_are_not_read(monkeypatch):
    ctx, metrics = traced("olmo1b-engine-decode", monkeypatch)
    n = len(program_spans.window_spans(ctx, "serve.prefill"))
    assert n == ctx.attempted
    ctx.t_window += ctx.window_s
    assert program_spans.window_spans(ctx, "serve.prefill") == []
    assert program_spans.median_ms(ctx, "serve.prefill") is None
    assert program_spans.slot_occupancy_pct(ctx) is None


def test_readers_give_none_over_an_older_program(monkeypatch):
    ctx, _ = traced("olmo1b-engine-decode", monkeypatch)
    from repro_torch import runtime
    from repro_torch.runtime import engine
    monkeypatch.setitem(sys.modules, "repro_torch.runtime.tracing", None)
    monkeypatch.delattr(runtime, "tracing")
    monkeypatch.delitem(engine.CAPTURE_COUNT, "s")
    monkeypatch.delattr(engine, "BIND_COUNT")
    for name in sorted(NEW):
        assert manifest.metric_reader(name).read(ctx) is None, name


def test_readers_give_none_when_records_were_dropped(monkeypatch):
    ctx, _ = traced("olmo1b-engine-decode", monkeypatch)
    from repro_torch.runtime import tracing
    monkeypatch.setattr(tracing, "_DROPPED", [1])
    for name in ("prefill_ms.tokens", "decode_enqueue_ms.tokens",
                 "slot_occupancy_pct.tokens"):
        assert manifest.metric_reader(name).read(ctx) is None, name


def test_setup_shares_read_nothing_where_the_window_captured(monkeypatch):
    ctx, _ = traced("lenet5-4b2b-clean-b4096", monkeypatch)
    ctx.counters["captures"] = 1
    assert program_spans.setup_pct(ctx, "CAPTURE_COUNT") is None
    assert program_spans.setup_pct(ctx, "BIND_COUNT") is None

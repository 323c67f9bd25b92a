"""The port's tracer (`runtime/tracing.py`) and the spans and counters of
the serving launcher and the compiled program, on the CPU.

With no profiler a span records nothing and makes no profiler range;
under the low-level profiler the benchmark runs (and under
`torch.profiler.profile`) spans nest, each naming the span open around
it, and their ranges are among the profiler's host events; the buffer
is bounded.  A tiny in-flight serve returns the same tokens with the
profiler on and off, with one "serve.prefill" a request, one
"serve.decode_step" a fused step and their `live` summing to the tokens
served less the requests.  `engine.BIND_COUNT` counts every
`bind_network` call.
"""
from __future__ import annotations

import collections
import contextlib

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.cim_layers import CIMConfig
from repro_torch.launch import serve
from repro_torch.models import cnn
from repro_torch.models import transformer as tf
from repro_torch.runtime import engine as rt
from repro_torch.runtime import tracing


@contextlib.contextmanager
def low_level_profiler():
    """The profiler as `bench/harness/trace.py` starts it (host events
    only here); yields a list that holds the host events' names after
    the block."""
    from torch.autograd import (ProfilerConfig, ProfilerState,
                                _disable_profiler, _enable_profiler,
                                _prepare_profiler)
    from torch._C._profiler import ProfilerActivity, _ExperimentalConfig
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    names = []
    try:
        yield names
    finally:
        names.extend(e.name() for e in _disable_profiler().events())


@contextlib.contextmanager
def public_profiler():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        names = []
        yield names
    names.extend(e.key for e in prof.key_averages())


PROFILERS = {"low_level": low_level_profiler, "public": public_profiler}


def new_records(before):
    return tracing.records()[before:]


def test_no_profiler_records_nothing_and_makes_no_range(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function with no profiler running")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    n, dropped = len(tracing.records()), tracing.dropped()
    with tracing.span("a", uid=1) as sp:
        with tracing.span("b"):
            sp.annotate(route="x")
    assert tracing.span("c") is tracing.OFF
    assert len(tracing.records()) == n and tracing.dropped() == dropped


@pytest.mark.parametrize("kind", sorted(PROFILERS))
def test_spans_nest_and_are_profiler_ranges(kind):
    n = len(tracing.records())
    with PROFILERS[kind]() as names:
        with tracing.span("t.outer", uid=3):
            with tracing.span("t.first") as sp:
                sp.annotate(route="replay")
            with tracing.span("t.second"):
                torch.ones(4).sum()
    recs = {r.name: r for r in new_records(n)}
    assert set(recs) == {"t.outer", "t.first", "t.second"}
    outer = recs["t.outer"]
    assert outer.parent_id is None and outer.attrs == {"uid": 3}
    for child in ("t.first", "t.second"):
        assert recs[child].parent_id == outer.span_id
        assert outer.t0_ns <= recs[child].t0_ns <= recs[child].t1_ns \
            <= outer.t1_ns
    assert recs["t.first"].attrs == {"route": "replay"}
    assert recs["t.first"].t1_ns <= recs["t.second"].t0_ns
    assert {"t.outer", "t.first", "t.second"} <= set(names)
    # closed in order: children before their parent
    assert [r.name for r in new_records(n)] == ["t.first", "t.second",
                                                "t.outer"]


def test_buffer_is_bounded_and_counts_what_fell_off(monkeypatch):
    monkeypatch.setattr(tracing, "_RECORDS", [])
    monkeypatch.setattr(tracing, "_DROPPED", [0])
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    with low_level_profiler():
        for i in range(5):
            with tracing.span("t.bounded", i=i):
                pass
    assert [r.attrs["i"] for r in tracing.records()] == [0, 1, 2]
    assert tracing.dropped() == 2
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped() == 0


def tiny_lm():
    """OLMo-1B's layout at the benchmark tests' tiny widths, every
    projection in engine mode at (8, 4), slots isolated."""
    cfg = get_config("olmo-1b").replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=512, head_dim=16, rope_theta=10000.0,
        norm_type="nonparam_ln", mlp_act="silu", gated_mlp=True,
        tie_embeddings=True, dtype="bfloat16",
        cim=CIMConfig(mode="engine", r_in=8, r_w=4, max_gamma=65536.0,
                      isolate_rows=True))
    params = tf.init_params(cfg, torch.Generator().manual_seed(5))
    reqs = serve.make_requests(cfg.vocab_size, 6, 6, 5, seed=3)
    return cfg, params, reqs


def test_inflight_under_the_profiler():
    """Tokens equal with the profiler on and off; one prefill span a
    request, one step span a fused step, Σ live = tokens - requests, and
    every span under the call's root, a request's spans by its uid."""
    cfg, params, reqs = tiny_lm()

    def run():
        return serve.inflight_serve(cfg, params, reqs, 3, max_len=19,
                                    device="cpu")
    off = run()
    n = len(tracing.records())
    with low_level_profiler() as names:
        on = run()
    assert on["tokens"] == off["tokens"] and on["slot"] == off["slot"]
    recs = new_records(n)
    by = collections.defaultdict(list)
    for r in recs:
        by[r.name].append(r)
    ids = {r.span_id: r for r in recs}
    served = sum(len(t) for t in on["tokens"].values())
    assert len(by["serve.inflight"]) == 1
    root = by["serve.inflight"][0]
    assert root.parent_id is None and root.attrs == {"slots": 3}
    assert len(by["serve.prefill"]) == len(by["serve.admit"]) == len(reqs)
    assert len(by["serve.retire"]) == len(reqs)
    assert len(by["serve.decode_step"]) == on["decode_steps"] > 0
    assert sum(r.attrs["live"] for r in by["serve.decode_step"]) \
        == served - len(reqs)
    assert all(r.attrs["slots"] == 3 and 0 < r.attrs["live"] <= 3
               for r in by["serve.decode_step"])
    for name in ("serve.prefill", "serve.slot_write"):
        for r in by[name]:
            parent = ids[r.parent_id]
            assert parent.name == "serve.admit"
            assert parent.attrs["uid"] == r.attrs["uid"]
    for name in ("serve.enqueue", "serve.readback", "serve.tokens_out"):
        assert len(by[name]) == on["decode_steps"]
        assert all(ids[r.parent_id].name == "serve.decode_step"
                   for r in by[name])
    assert {r.attrs["uid"] for r in by["serve.admit"]} \
        == {q["uid"] for q in reqs}
    for r in recs:
        top = r
        while top.parent_id is not None:
            top = ids[top.parent_id]
        assert top is root
    # the projections' dispatches run inside the launcher's spans (eager
    # on the host)
    disp = by["program.dispatch"]
    assert disp and all(r.attrs["route"] == "eager" for r in disp)
    assert {"serve.inflight", "serve.prefill", "serve.decode_step",
            "program.dispatch"} <= set(names)


def test_dispatch_span_names_route_bucket_and_rows():
    prog = cnn.lenet_program(8, cim=CIMConfig(mode="engine", r_in=4, r_w=2),
                             device="cpu")
    params = prog.init_params(torch.Generator().manual_seed(1))
    bound = prog.bind(params)
    x = torch.rand(5, 28, 28, 1, generator=torch.Generator().manual_seed(2))
    n = len(tracing.records())
    with low_level_profiler():
        bound.serve(x)
    (rec,) = new_records(n)
    assert rec.name == "program.dispatch" and rec.parent_id is None
    assert rec.attrs == {"route": "eager", "bucket": 8, "rows": 5}


def test_bind_count_grows_one_a_bind():
    prog = cnn.lenet_program(8, cim=CIMConfig(mode="engine", r_in=4, r_w=2),
                             device="cpu")
    params = prog.init_params(torch.Generator().manual_seed(1))
    x = torch.rand(3, 28, 28, 1, generator=torch.Generator().manual_seed(2))
    n0, s0 = rt.BIND_COUNT["n"], rt.BIND_COUNT["s"]
    bound = prog.bind(params)
    assert rt.BIND_COUNT["n"] == n0 + 1 and rt.BIND_COUNT["s"] > s0
    bound.serve(x)
    assert rt.BIND_COUNT["n"] == n0 + 1
    prog.serve(params, x)                  # per-call params bind each call
    assert rt.BIND_COUNT["n"] == n0 + 2
    with pytest.raises(ValueError):
        rt.bind_network(prog.plan, params[:1])
    assert rt.BIND_COUNT["n"] == n0 + 2

"""What decides `correct`: runs of each cell's kind on the CPU at tiny
sizes come out correct; the control (the reference in the precision
below the configuration's), put in the program's place, comes out not
correct; and so does a run whose timed path alters an answer where it
is produced, or drops or cuts short a request.
"""
from __future__ import annotations

import pytest
import torch

from bench.harness.result import assemble
from bench.tests.cpu import run_cpu, tiny_cell

LENET = {"batch": 16, "pool_batches": 2}
OLMO_CFG = {"hidden_size": 64, "intermediate_size": 128,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 4, "head_dim": 16, "vocab_size": 512}
# at this size the program reads a served gap near 0.01 and the fp8
# control near 0.15 (the cells' own limit is set from readings at the
# published widths, where the control reads 0.8 or more)
OLMO_MIX = {"slots": 4, "requests": 6, "prompt_len": [5, 20], "gen": [2, 6],
            "arrival": [0, 6], "checked_requests": 6, "round_seconds": 1.0,
            "limits": {"served_gap": 0.05}}
TINY = {
    "lenet5-4b2b-clean-b4096": ({}, LENET),
    "olmo1b-engine-decode": (OLMO_CFG, OLMO_MIX),
    "olmo1b-engine-prefill": (OLMO_CFG, OLMO_MIX),
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def cell(name):
    conf, mix = TINY[name]
    return tiny_cell(name, conf, mix)


def correct(ctx) -> bool:
    return assemble(ctx, {}, "cpu", "")["correct"]


@pytest.mark.parametrize("name", sorted(TINY))
def test_tiny_run_is_correct_and_control_fails(name):
    """One run with the control in the program's place: the program's
    own reading (in the notes) is within the limit, the control's is
    not, and the run comes out not correct."""
    ctx = run_cpu(cell(name), seed=2 ** 31 + 17, control=True)
    assert ctx.attempted > 0
    gap = ctx.checks[0]
    assert ctx.notes[f"program_{gap.name}"] <= gap.limit
    assert not gap.ok and gap.value > gap.limit, (gap.value, gap.limit)
    assert all(c.ok for c in ctx.checks[1:])
    assert not correct(ctx)


def test_altered_answer_is_not_correct(monkeypatch):
    """One logit of every batch moved by half the largest logit, where
    the program makes it."""
    from repro_torch.runtime import program
    orig = program.BoundProgram.serve

    def broken(self, *a, **kw):
        y = orig(self, *a, **kw).clone()
        y[0, 3] += 0.5 * torch.max(torch.abs(y))
        return y
    monkeypatch.setattr(program.BoundProgram, "serve", broken)
    ctx = run_cpu(cell("lenet5-4b2b-clean-b4096"))
    assert not all(c.ok for c in ctx.checks)
    assert not correct(ctx)


@pytest.mark.parametrize("name", ["olmo1b-engine-decode",
                                  "olmo1b-engine-prefill"])
def test_altered_token_is_not_correct(monkeypatch, name):
    """Every served token replaced by the one its greedy choice ranks
    last at position 0 of the vocabulary order: token 0 where it was not
    chosen, else token 1."""
    from repro_torch.launch import serve
    orig = serve.inflight_serve

    def broken(*a, **kw):
        out = orig(*a, **kw)
        for uid, toks in out["tokens"].items():
            out["tokens"][uid] = [1 if t == 0 else 0 for t in toks]
        return out
    monkeypatch.setattr(serve, "inflight_serve", broken)
    ctx = run_cpu(cell(name))
    assert not all(c.ok for c in ctx.checks)
    assert not correct(ctx)


@pytest.mark.parametrize("fault", ["dropped", "cut_short"])
def test_dropped_or_cut_request_is_not_correct(monkeypatch, fault):
    """A round that returns one request less, or one request with a token
    less, comes out not correct, though every token it does return is
    the program's own."""
    from repro_torch.launch import serve
    orig = serve.inflight_serve

    def broken(*a, **kw):
        out = orig(*a, **kw)
        uid = max(out["tokens"], key=lambda u: len(out["tokens"][u]))
        if fault == "dropped":
            del out["tokens"][uid]
        else:
            out["tokens"][uid] = out["tokens"][uid][:-1]
        return out
    monkeypatch.setattr(serve, "inflight_serve", broken)
    ctx = run_cpu(cell("olmo1b-engine-decode"))
    checks = {c.name: c for c in ctx.checks}
    assert checks["served_gap"].ok
    assert not checks["unfinished_requests"].ok
    assert ctx.failed > 0 and not correct(ctx)

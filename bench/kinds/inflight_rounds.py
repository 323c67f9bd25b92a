"""Rounds of in-flight serving through the launcher's `inflight_serve`,
every projection in engine mode.

A round is the mix's requests (`harness/requests.py`) served over
`slots` slots: each request admitted at its arrival tick is prefilled
alone into its slot, and every tick with live requests runs one fused
single-token step over all slots.  The window is
max(1, round(seconds / round_seconds)) rounds back to back, the mix's
`round_seconds` a round's pace on the card when the mix was sized: a
count fixed before the window, since a window that stops when its own
clock passes the seconds ends slow runs a round early and fast ones a
round late, and so spreads the rate.  Every round holds the same shapes
(`harness/requests.py`), and set-up serves one round first, so every
prefill length and every graph the window meets is warm.  A traced run's
window is one round (a round's timeline is a million events).

Every request has to come back with its whole budget of tokens (no
request ends early: the mix has no end-of-sequence token).  A sample of
the finished requests, drawn from the seed and with the longest among
them, is held against the plain reference's full forward over prompt
and served tokens.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from bench.harness import counters, inputs, requests
from bench.harness.context import Check, Context
from bench.harness.work import Work
from bench.reference import olmo as ref

WARM_ROUND = 1 << 20
PROJECTIONS = (("wq", "d", "a"), ("wk", "d", "a"), ("wv", "d", "a"),
               ("wo", "a", "d"), ("w_up", "d", "f"), ("w_gate", "d", "f"),
               ("w_down", "f", "d"))


def model_config(cfg: dict):
    """The port's ModelConfig with every size of the configuration file."""
    from repro_torch.configs import get_config
    from repro_torch.core.cim_layers import CIMConfig
    return get_config(cfg["arch"]).replace(
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg["head_dim"], rope_theta=cfg["rope_theta"],
        norm_type="nonparam_ln", mlp_act="silu", gated_mlp=True,
        tie_embeddings=True, dtype=cfg["dtype"],
        cim=CIMConfig(mode="engine", r_in=cfg["r_in"], r_w=cfg["r_w"],
                      max_gamma=cfg["max_gamma"], isolate_rows=True))


def run(ctx: Context) -> None:
    from repro_torch.launch.serve import inflight_serve
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    mcfg = model_config(cfg)
    params = inputs.olmo_weights(cfg, ctx.seed, ctx.device)
    vocab, slots = cfg["vocab_size"], mix["slots"]
    length = requests.max_len(mix)

    def serve(reqs):
        return inflight_serve(mcfg, params, reqs, slots, max_len=length,
                              device=ctx.device)

    t0 = time.perf_counter()
    serve(requests.make_round(mix, ctx.seed, WARM_ROUND, vocab))
    ctx.sync()
    ctx.notes["warm_round_s"] = time.perf_counter() - t0
    before = counters.snapshot()
    n_rounds = 1 if ctx.tracing else max(
        1, round(ctx.seconds / mix["round_seconds"]))
    rounds, ends = [], []
    with ctx.window():
        for i in range(n_rounds):
            reqs = requests.make_round(mix, ctx.seed, i, vocab)
            with ctx.spans.span("round"):
                out = serve(reqs)
            rounds.append((reqs, out))
            ends.append(ctx.elapsed())
    ctx.read_peak()
    ctx.counters = counters.growth(before)
    served = sum(len(t) for _, o in rounds for t in o["tokens"].values())
    ctx.attempted = sum(len(r) for r, _ in rounds)
    unfinished = sum(len(o["tokens"].get(q["uid"], ())) != q["gen"]
                     for r, o in rounds for q in r)
    ctx.failed = unfinished
    walls = np.diff([0.0] + ends)
    ctx.notes["rounds"] = len(rounds)
    ctx.notes["round_s_range_pct"] = float(
        100 * (walls.max() - walls.min()) / np.median(walls))
    ctx.e2e["tokens_per_s"] = served / ctx.window_s
    ctx.entry = {k: sum(o[k] for _, o in rounds)
                 for k in ("decode_s", "decode_steps", "wall_s")}
    ctx.work = round_work(cfg, mix, rounds)
    t0 = time.perf_counter()
    check(ctx, params, rounds)
    ctx.notes["reference_s"] = time.perf_counter() - t0
    ctx.checks.append(Check("unfinished_requests", unfinished, 0))


def round_work(cfg: dict, mix: dict, rounds) -> Work:
    """The products of the window: every prefill at its prompt's rows and
    every fused step at `slots` rows through the seven projections a
    layer and the tied head; attention over the (query, key) pairs each
    request needs, in float32 as the program runs it."""
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    a = cfg["head_dim"] * cfg["num_attention_heads"]
    dims = {"d": d, "a": a, "f": f}
    layers = cfg["num_hidden_layers"]
    w = Work()

    def forward(m, calls=1):
        for _, k, n in PROJECTIONS:
            w.add_cim(m, dims[k], dims[n], cfg["r_in"], True,
                      calls * layers)
        w.add_ops("bf16", 2.0 * m * d * v * calls)

    for reqs, out in rounds:
        forward(mix["slots"], out["decode_steps"])
        for q in reqs:
            p = len(q["prompt"])
            forward(p)
            g = len(out["tokens"].get(q["uid"], ()))
            pairs = p * (p + 1) // 2 + sum(p + i + 1 for i in range(g - 1))
            w.add_ops("f32", 4.0 * pairs * a * layers)
    return w


def check(ctx: Context, params, rounds) -> None:
    """The widest gap by which a served token's reference logit lies
    below the reference's best, over a sample of the finished requests
    drawn from the seed, the longest among them.  With `ctx.control` the
    tokens the control puts first at the same positions stand in the
    served ones' place, and the program's reading goes to the notes."""
    cfg, mix = ctx.cell.config, ctx.cell.traffic
    limit = mix["limits"]["served_gap"]
    done = [(q, o["tokens"][q["uid"]]) for r, o in rounds for q in r
            if o["tokens"].get(q["uid"])]
    if not done:
        ctx.checks.append(Check("served_gap", float("nan"), limit))
        return
    longest = max(range(len(done)),
                  key=lambda i: len(done[i][0]["prompt"]) + len(done[i][1]))
    rng = random.Random(ctx.seed)
    rest = [i for i in range(len(done)) if i != longest]
    pick = [longest] + rng.sample(rest, min(len(rest),
                                            mix["checked_requests"] - 1))
    worst, program = 0.0, 0.0
    for i in pick:
        q, toks = done[i]
        p = len(q["prompt"])
        seq = torch.as_tensor(list(q["prompt"]) + list(toks[:-1]),
                              device=ctx.device)
        logits = ref.logits(cfg, params, seq, p)
        if ctx.control:
            program = max(program, ref.served_gap(logits, toks, p))
            low = ref.logits(cfg, params, seq, p,
                             act=getattr(torch, cfg["control_dtype"]))
            toks = ref.greedy(low, p, len(toks))
        gap = ref.served_gap(logits, toks, p)
        worst = max(worst, gap) if gap == gap else float("nan")
        ctx.failed += int(not gap <= limit)
    ctx.checks.append(Check("served_gap", worst, limit))
    ctx.notes["checked_tokens"] = sum(len(done[i][1]) for i in pick)
    if ctx.control:
        ctx.notes["program_served_gap"] = program

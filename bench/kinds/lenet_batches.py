"""Closed-loop batches through LeNet's compiled program, noise off.

One client hands batches of `batch` images from a pool made at set-up
(a test set kept on the device) to
`cnn.lenet_program(batch, cim).bind(params).serve(x)`, the graph-replayed
path, and waits for the logits on the host before the next.  The window's
batches are sampled from the seed and held against the plain reference.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench.harness import counters, inputs
from bench.harness.context import Check, Context
from bench.harness.sample import Reservoir
from bench.harness.work import Work
from bench.reference import lenet as ref


def build(ctx: Context):
    """(bound program, pool of images, params) of the cell."""
    from repro_torch.core.cim_layers import CIMConfig
    from repro_torch.models import cnn
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    params = inputs.lenet_weights(cfg, ctx.seed, ctx.device)
    pool = inputs.images(tr["batch"] * tr["pool_batches"], ctx.seed,
                         ctx.device)
    cim = CIMConfig(mode="engine", r_in=cfg["r_in"], r_w=cfg["r_w"],
                    max_gamma=cfg["max_gamma"])
    prog = cnn.lenet_program(tr["batch"], cim=cim, device=ctx.device)
    bound = prog.bind([params[name] for name, _, _ in cfg["layers"]])
    return bound, pool, params


def run(ctx: Context) -> None:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    batch, n_pool = tr["batch"], tr["pool_batches"]
    bound, pool, params = build(ctx)

    def x_of(i):
        j = i % n_pool
        return pool[j * batch:(j + 1) * batch]

    for i in range(n_pool):            # every graph the window replays
        bound.serve(x_of(i)).cpu()
    ctx.sync()
    before = counters.snapshot()
    keep = Reservoir(tr["checked_batches"], ctx.seed)
    lat = []
    i = 0
    with ctx.window():
        while True:
            t0 = time.perf_counter()
            with ctx.spans.span("serve"):
                y = bound.serve(x_of(i))
            with ctx.spans.span("to_host"):
                yh = y.cpu()
            lat.append(time.perf_counter() - t0)
            keep.offer(i, lambda: yh)
            i += 1
            if ctx.elapsed() >= ctx.seconds:
                break
    ctx.read_peak()
    ctx.counters = counters.growth(before)
    ctx.attempted = i
    ctx.e2e["images_per_s"] = i * batch / ctx.window_s
    ctx.e2e["batch_ms_p95"] = 1e3 * float(np.percentile(lat, 95))
    ctx.work = layer_work(cfg, batch, i)
    del bound
    t0 = time.perf_counter()
    check(ctx, params, pool, keep.kept())
    ctx.notes["reference_s"] = time.perf_counter() - t0


def layer_work(cfg, batch: int, calls: int) -> Work:
    w = Work()
    for m, k, n in ref.layer_shapes(batch):
        w.add_cim(m, k, n, cfg["r_in"], False, calls)
    return w


def check(ctx: Context, params, pool, kept) -> None:
    """Each sampled batch's logits against the reference's, as a share of
    the reference's largest logit.  With `ctx.control` the control's
    logits stand in the program's place, and the program's reading goes
    to the notes."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    batch, n_pool = tr["batch"], tr["pool_batches"]
    kw = dict(r_in=cfg["r_in"], r_w=cfg["r_w"], max_gamma=cfg["max_gamma"])
    limit = tr["limits"]["logit_gap"]
    refs, lows = {}, {}
    worst, program = 0.0, 0.0
    for i, yh in sorted(kept.items()):
        j = i % n_pool
        x = pool[j * batch:(j + 1) * batch]
        if j not in refs:
            refs[j] = ref.forward(params, x, **kw)
        if ctx.control:
            program = max(program, ref.logit_gap(yh, refs[j]))
            if j not in lows:
                lows[j] = ref.forward(
                    params, x, dt=getattr(torch, cfg["control_dtype"]), **kw)
            yh = lows[j]
        gap = ref.logit_gap(yh, refs[j])
        worst = max(worst, gap) if gap == gap else float("nan")
        ctx.failed += int(not gap <= limit)
    ctx.checks.append(Check("logit_gap", worst, limit))
    if ctx.control:
        ctx.notes["program_logit_gap"] = program

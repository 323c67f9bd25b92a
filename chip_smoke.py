"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one line of output each (the decode phase prints a few), in
order; any failure raises and the script exits non-zero without printing
a result:

  1. build    - compile every CUDA kernel of the port from the sources in
                this checkout (nvcc, one process per source, in parallel);
                prints build seconds and ptxas register/shared-memory use.
  2. kernels  - each kernel against its plain PyTorch version on the card.
                cim_mbiw: torch.equal over the precision grid, both beta
                shapes, both ADC modes, ragged shapes, the LeNet tiles at
                batch 256 and an FMA canary (inputs where a fused
                multiply-add would move codes).  ring_decode: within
                rtol = atol = 1e-5 over R {1,3,4,8} x H {1,16} x hd {12,128}
                x L {1,37,2048} with ragged valid-slot counts, on strided
                views of a decode-state slab, and each row of an R-row call
                bit for bit equal to a one-row call.
  3. lenet    - the first main path: LeNet (28x28x1 -> conv16 -> pool ->
                conv32 -> pool -> fc 1568->128 -> fc 128->10) served at full
                width through compile_program(...).bind(...).serve at
                (r_in, r_w) (4, 2) and (8, 4), weights from a seeded
                torch.Generator, images from pseudo-MNIST; logits equal the
                reference on the card and the port's CPU run bit for bit,
                serve_batch equals serve of the concatenation, and the
                kernel ran once per planned macro tile.  Median latency
                and images/s at 256.
  4. decode   - the second main path: in-flight decode serving
                (InflightScheduler over CIMDecodeLM) at OLMo-1B widths
                (d 2048, 16 heads, d_ff 8192, vocab 50304, window 2048,
                RoPE theta 1e4; depth DECODE_DEPTH), points "" = (4, 2)
                and "quality" = (8, 4), weights from a seeded
                torch.Generator.  8 requests from numpy seed 0 at capacity
                4; every fused stream equals its solo decode_sequential,
                cim_mbiw launched planned tiles x model calls and
                ring_decode depth x model calls, a bound projection equals
                its card reference.  Bind seconds, median fused-step
                latency per point, tokens/s, and the profiler's device
                time and busy share of one fused step per point.
  5. times    - CUDA-event times of each kernel, its plain version and a
                library call computing the same function (torch._int_mm
                for cim_mbiw, scaled_dot_product_attention for
                ring_decode: yardsticks the port never calls), beside the
                least time the card could take (the larger of operations
                over the peak rate of their type and bytes / 3.35 TB/s, the
                H100 SXM's published peaks), at the LeNet tiles, the decode
                tiles and the decode attention shape.

Then the `kernels` JSON line, the card's name and power limit as
nvidia-smi reports them, and last the JSON result line.  Detailed numbers
go to chiprun_out/chip_smoke.json.  Exits non-zero (printing no result)
without a CUDA device or outside a checkout of the repository.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_INT8_OPS = 1979e12        # H100 SXM dense int8 tensor-core rate
PEAK_F32_OPS = 67e12           # H100 SXM float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12           # H100 SXM HBM3 bandwidth
LENET_BATCH = 256
REQUESTS = (1, 7, 100)
PRECISIONS = ((4, 2), (8, 4))
# OLMo-1B's widths (arXiv:2402.00838); depth is the only cut: 6 of its 16
# blocks keep the whole script well inside its time limit, since the
# decode phase's cost grows with depth (PERF.md has the full depth's run)
DECODE_WIDTHS = dict(d=2048, n_heads=16, d_ff=8192, vocab=50304,
                     window=2048, rope_theta=1e4)
DECODE_DEPTH = 6
DECODE_POINTS = {"": (4, 2), "quality": (8, 4)}
DECODE_CAPACITY = 4
DECODE_REQUESTS = 8


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi reported no card")
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_profile(fn, reps: int, cpu: bool = True) -> dict:
    """torch.profiler over `reps` calls: device microseconds per call (all
    kernels, those of cim_mbiw and of ring_decode, and the eight largest
    by name) and the host wall time per call under the profiler.  With
    `cpu=False` only the device is traced (fewer events for a call that
    launches many thousand kernels).  Empty dict when the profiler saw no
    device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for evt in prof.events():
        if getattr(evt, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.device_time_total
    total = sum(by_name.values())
    if total <= 0:
        return {}
    mbiw = sum(v for k, v in by_name.items() if "cim_mbiw" in k)
    ring = sum(v for k, v in by_name.items() if "ring_decode" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_us": total / reps, "cim_mbiw_us": mbiw / reps,
            "ring_decode_us": ring / reps, "wall_us": 1e6 * wall / reps,
            "device_busy": total / (1e6 * wall),
            "top_kernels_us": {k[:80]: v / reps for k, v in top}}


def bound_ms(m: int, k: int, n: int, planes: int, beta_rows: bool) -> tuple:
    """Least time (ms) for one cim_mbiw call and what bounds it: each
    input byte read once, each output byte written once."""
    ops = 2.0 * m * n * k * planes
    nbytes = m * planes * k + k * n + 4 * n + 4 * n * (m if beta_rows else 1) \
        + 4 * m * n
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def ring_bound_ms(r: int, l: int, h: int, hd: int) -> tuple:
    """Least time (ms) for one ring_decode call and what bounds it: q, k,
    v, bias read once and the output written once, against the float32
    work of the two products (2 operations per multiply-add)."""
    nbytes = 4 * (2 * r * l * h * hd + 2 * r * h * hd + r * l)
    ops = 4.0 * r * h * l * hd
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def ring_inputs(r: int, l: int, h: int, hd: int, seed: int, dev) -> list:
    """q (R, H, hd); k, v as block 1 of a (R, 2, L, H, hd) state slab
    (strided views, as the scheduler passes them); bias with 1..L valid
    slots per row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((r, h, hd), generator=g, device=dev)
    k = torch.randn((r, 2, l, h, hd), generator=g, device=dev)[:, 1]
    v = torch.randn((r, 2, l, h, hd), generator=g, device=dev)[:, 1]
    valid = torch.randint(1, l + 1, (r,), generator=g, device=dev)
    bias = torch.where(torch.arange(l, device=dev)[None, :]
                       < valid[:, None], 0.0, -1e9).to(torch.float32)
    return [q, k, v, bias]


def decode_requests(vocab: int) -> list:
    """The decode schedule: numpy seed 0, DECODE_REQUESTS requests with
    prompts of 1-4 tokens, 1-6 new tokens, arrivals at steps 0-6, points
    alternating "" and "quality".  Returns [(arrival, uid, prompt,
    max_new_tokens, point)]."""
    rng = np.random.default_rng(0)
    out = []
    for uid in range(DECODE_REQUESTS):
        prompt = tuple(int(t) for t in
                       rng.integers(0, vocab, size=int(rng.integers(1, 5))))
        max_new = int(rng.integers(1, 7))
        out.append((int(rng.integers(0, 7)), uid, prompt, max_new,
                    "" if uid % 2 == 0 else "quality"))
    return out


def main() -> int:
    depth = DECODE_DEPTH
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.cim_layers import CIMConfig
    from repro_torch.core import digital_ref
    from repro_torch.data.pseudo_mnist import make_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels.cim_mbiw import kernel as kmod
    from repro_torch.kernels.cim_mbiw import ops as kops
    from repro_torch.kernels.cim_mbiw import ref as kref
    from repro_torch.kernels.flash_attn import kernel as rmod
    from repro_torch.kernels.flash_attn import ref as rref
    from repro_torch.models import cnn
    from repro_torch.runtime.scheduler import (CIMDecodeLM,
                                               InflightScheduler, Request,
                                               decode_sequential)

    # the plain versions' products run in float64 (no TF32 there); stated
    # here all the same so no float32 yardstick can drift into TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    tag = f"[{card}]"
    report = {"card": card, "device": torch.cuda.get_device_name(0)}
    kern = kmod.cim_mbiw_matmul_planes
    ring = rmod.ring_decode
    t_start = t_phase = time.perf_counter()
    phase_s: dict = {}

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    infos = build.build_all(force=True)
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.split("ptxas info    :")[-1].strip()
                    for ln in info.log.splitlines()
                    if "registers" in ln or "Used" in ln]
             for name, info in infos.items()}
    report["build"] = {"seconds": build_s, "ptxas": ptxas,
                       "per_kernel_s": {n: i.seconds
                                        for n, i in infos.items()}}
    print(f"build: {len(infos)} kernel(s) in {build_s:.1f} s; "
          + "; ".join(f"{n}: {' | '.join(v)}" for n, v in ptxas.items()),
          flush=True)

    phase_s["build"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 2. kernel vs plain version ------------------------------------------
    rng = np.random.default_rng(0)

    def tile_inputs(m, k, n, r_in, r_w, beta_rows):
        full = 2**r_w - 1
        x = torch.from_numpy(rng.integers(0, 2**r_in, size=(m, k),
                                          dtype=np.int32))
        w = torch.from_numpy((2 * rng.integers(-(full + 1) // 2,
                                               (full + 1) // 2, size=(k, n))
                              + 1).astype(np.int8))
        gamma = torch.from_numpy(
            (2.0 ** rng.uniform(0, 5, size=(1, n))).astype(np.float32))
        beta = torch.from_numpy(rng.uniform(
            -16, 16, size=(m if beta_rows else 1, n)).astype(np.float32))
        shift, _ = kmod.plane_layout(r_in)
        planes, _ = kops.split_planes(x, r_in, shift)
        return shift, [t.to(dev) for t in (planes, w, gamma, beta)]

    def compare(m, k, n, r_in, r_w, r_out, beta_rows, fuse_adc):
        shift, args = tile_inputs(m, k, n, r_in, r_w, beta_rows)
        g0 = digital_ref.adc_gain_factor(r_in, r_w, r_out,
                                         36 * -(-min(k, 1152) // 36))
        kw = dict(plane_shift=shift, g0=g0, r_out=r_out, fuse_adc=fuse_adc)
        got = kern(*args, **kw)
        want = kref.cim_mbiw_matmul_planes_ref(*args, **kw)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"cim_mbiw != plain at {(m, k, n, r_in, r_w, r_out)} "
              f"beta_rows={beta_rows} fuse_adc={fuse_adc}")
        return int((got.long() - want.long()).abs().max())

    cases, max_err = 0, 0
    for r_in in (1, 2, 3, 4, 8):
        for r_w in (1, 2, 4):
            for r_out in (1, 4, 8):
                for beta_rows in (False, True):
                    for fuse in (True, False):
                        max_err = max(max_err, compare(
                            70, 200, 40, r_in, r_w, r_out, beta_rows, fuse))
                        cases += 1
    ragged = [(17, 300, 33), (100, 1152, 64), (1, 9, 1), (129, 37, 65)]
    lenet_tiles = {(4, 2): [(LENET_BATCH * 784, 9, 16),
                            (LENET_BATCH * 196, 144, 32),
                            (LENET_BATCH, 784, 128), (LENET_BATCH, 128, 10)],
                   (8, 4): [(LENET_BATCH * 784, 9, 16),
                            (LENET_BATCH * 196, 144, 32),
                            (LENET_BATCH, 784, 64), (LENET_BATCH, 128, 10)]}
    shapes = [s + (8, 4) for s in ragged] + [
        s + p for p, tiles in lenet_tiles.items() for s in tiles]
    for (m, k, n, r_in, r_w) in shapes:
        for beta_rows in (False, True):
            for fuse in (True, False):
                max_err = max(max_err, compare(m, k, n, r_in, r_w, 8,
                                               beta_rows, fuse))
                cases += 1
    canary = kref.fma_canary(0)
    c_args = [torch.from_numpy(canary[k]).to(dev)
              for k in ("x", "w", "gamma", "beta")]
    got = kops.cim_matmul(*c_args, r_in=8, r_out=canary["r_out"],
                          g0=canary["g0"]).cpu().numpy()
    flips = int(np.sum(canary["codes"] != canary["codes_fma"]))
    check(np.array_equal(got, canary["codes"]),
          "FMA canary: kernel codes differ from the rounded chain")
    cases += 1
    report["kernel_vs_plain"] = {"cases": cases, "max_abs_err": max_err,
                                 "canary_fma_flips": flips}
    print(f"kernels: cim_mbiw == plain on {cases} cases (grid r_in "
          f"{{1,2,3,4,8}} x r_w {{1,2,4}} x r_out {{1,4,8}} x beta (1,N)/"
          f"(M,N) x fuse_adc, ragged, LeNet tiles at batch {LENET_BATCH}, "
          f"FMA canary with {flips} codes an FMA would move), "
          f"max_abs_err {max_err}", flush=True)

    rcases, rmax = 0, 0.0
    for r in (1, 3, 4, 8):
        for h in (1, 16):
            for hd in (12, 128):
                for l in (1, 37, 2048):
                    args = ring_inputs(r, l, h, hd, rcases, dev)
                    got = ring(*args)
                    want = rref.ring_decode_attention_ref(*args)
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                          f"ring_decode != plain at R={r} H={h} hd={hd} "
                          f"L={l} (max abs err {err})")
                    for i in range(r):
                        one = ring(*(a[i:i + 1] for a in args))
                        check(torch.equal(got[i:i + 1], one),
                              f"ring_decode row {i} of R={r} != its "
                              f"one-row call (H={h} hd={hd} L={l})")
                    rmax = max(rmax, err)
                    rcases += 1
    report["ring_vs_plain"] = {"cases": rcases, "max_abs_err": rmax}
    print(f"kernels: ring_decode within rtol=atol=1e-5 of plain on {rcases} "
          f"cases (R {{1,3,4,8}} x H {{1,16}} x hd {{12,128}} x L "
          f"{{1,37,2048}}, ragged valid slots, strided state views), "
          f"max_abs_err {rmax:.3g}; every row bit-equal to its one-row "
          f"call", flush=True)

    phase_s["kernels"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 3. LeNet served at full width (the first main path) -----------------
    n_img = LENET_BATCH + sum(REQUESTS)
    images = torch.from_numpy(make_dataset(n_train=1, n_test=n_img,
                                           seed=0)[2][..., None])
    x = images[:LENET_BATCH]
    reqs, s = [], LENET_BATCH
    for b in REQUESTS:
        reqs.append(images[s:s + b])
        s += b
    main_launches = 0
    lenet = {}
    for r_in, r_w in PRECISIONS:
        cim = CIMConfig(r_in=r_in, r_w=r_w)
        params = cnn.lenet_params_list(
            cnn.init_lenet(torch.Generator().manual_seed(0), cim=cim))
        prog = cnn.lenet_program(LENET_BATCH, cim=cim)
        check(prog.device.type == "cuda", "program is not on the card")
        bound = prog.bind(params)
        per_fwd = prog.plan.total_macro_evals
        kern.launches = 0
        y = bound.serve(x)
        torch.cuda.synchronize()
        launches_serve = kern.launches
        kern.launches = 0
        ys = bound.serve_batch(reqs)
        torch.cuda.synchronize()
        launches_batch = kern.launches
        main_launches += launches_serve + launches_batch
        check(launches_serve == per_fwd and launches_batch == per_fwd,
              f"kernel launches per forward {launches_serve}/"
              f"{launches_batch} != planned tiles {per_fwd}")
        check(tuple(y.shape) == (LENET_BATCH, 10) and y.is_cuda
              and bool(torch.isfinite(y).all()), "logits shape/finiteness")
        before = kern.launches
        y_ref = bound.reference(x)
        check(kern.launches == before, "the reference launched the kernel")
        check(torch.equal(y, y_ref), "card logits != card reference")
        host = cnn.lenet_program(LENET_BATCH, cim=cim, device="cpu")
        y_cpu = host.bind(params).serve(x)
        check(torch.equal(y.cpu(), y_cpu), "card logits != CPU run")
        check(torch.equal(torch.cat(ys), bound.serve(torch.cat(reqs))),
              "serve_batch != serve of the concatenation")
        lat = []
        for _ in range(20):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bound.serve(x)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        med = statistics.median(lat[3:])
        prof = device_profile(lambda: bound.serve(x), 10)
        lenet[f"{r_in},{r_w}"] = {
            "launches_per_forward": launches_serve,
            "planned_tiles": per_fwd, "median_latency_ms": 1e3 * med,
            "images_per_s": LENET_BATCH / med,
            "latencies_ms": [1e3 * t for t in lat], "profile": prof}
        busy = (f"device busy {100 * prof['device_busy']:.1f}% of a "
                f"profiled serve, cim_mbiw {prof['cim_mbiw_us']:.1f} of "
                f"{prof['device_us']:.1f} device us" if prof
                else "device time not measured (profiler saw none)")
        print(f"lenet ({r_in},{r_w}) {tag}: batch {LENET_BATCH} logits == "
              f"card reference == CPU run (bit for bit), serve_batch "
              f"{list(REQUESTS)} == serve(concat); {launches_serve} kernel "
              f"launches per forward (= planned tiles); median serve "
              f"{1e3 * med:.3f} ms, {LENET_BATCH / med:.0f} images/s; "
              f"{busy}", flush=True)
    report["lenet"] = lenet
    phase_s["lenet"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 4. in-flight decode serving at OLMo-1B widths (the second path) -----
    t0 = time.perf_counter()
    model = CIMDecodeLM.toy(
        torch.Generator().manual_seed(0), depth=depth,
        r_in=DECODE_POINTS[""][0], r_w=DECODE_POINTS[""][1],
        points={"quality": DECODE_POINTS["quality"]}, **DECODE_WIDTHS)
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    check(model.device.type == "cuda", "decode model is not on the card")
    tiles = {p: sum(b.qkv.program.plan.total_macro_evals
                    + b.o.plan.total_macro_evals
                    + b.gate_up.program.plan.total_macro_evals
                    + b.down.plan.total_macro_evals
                    for b in model.blocks_for(p)) for p in model.points}
    sched_in = decode_requests(model.vocab)
    reqs = {u: Request(u, p, n, pt) for _, u, p, n, pt in sched_in}
    arrivals = [(t, reqs[u]) for t, u, *_ in sched_in]

    # fused-step wall times per point (the scheduler syncs on the tokens)
    step_ms: dict = {}
    inner = model.step_rows

    def timed_step(state, tokens, *a, point="", commit=None, **kw):
        t = time.perf_counter()
        out = inner(state, tokens, *a, point=point, commit=commit, **kw)
        torch.cuda.synchronize()
        if commit is not None:
            step_ms.setdefault(point, []).append(
                1e3 * (time.perf_counter() - t))
        return out
    model.step_rows = timed_step
    kern.launches = ring.launches = 0
    sched = InflightScheduler(model, capacity=DECODE_CAPACITY)
    t0 = time.perf_counter()
    streams = sched.run(arrivals)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    dec_cim, dec_ring = kern.launches, ring.launches
    del model.step_rows
    calls = {p: sum(len(r.prompt) for r in reqs.values() if r.point == p)
             + sched.points_served.get(p, 0) for p in model.points}
    planned = sum(tiles[p] * calls[p] for p in calls)
    check(dec_cim == planned, f"decode cim_mbiw launches {dec_cim} != "
          f"planned tiles x calls {planned}")
    check(dec_ring == depth * sum(calls.values()),
          f"decode ring_decode launches {dec_ring} != depth x calls "
          f"{depth * sum(calls.values())}")
    check(set(streams) == set(reqs), "not every request finished")
    for u, r in reqs.items():
        toks = streams[u]
        check(len(toks) == r.max_new_tokens
              and all(0 <= t < model.vocab for t in toks),
              f"request {u} stream {toks} has the wrong length or range")
    t0 = time.perf_counter()
    for u, r in reqs.items():
        check(decode_sequential(model, r) == streams[u],
              f"request {u} ({r.point!r}): fused stream != solo decode")
    solo_s = time.perf_counter() - t0
    # a bound projection on the card against its plain reference, with
    # one segment per row and a 100x spread of swings
    g = torch.Generator(device=dev).manual_seed(1)
    h = torch.randn((4, model.d), generator=g, device=dev) * torch.tensor(
        [[1.0], [100.0], [0.1], [3.0]], device=dev)
    for p in model.points:
        qkv = model.blocks_for(p)[0].qkv.bound
        seg = torch.arange(4, device=dev)
        check(torch.equal(qkv.serve(h, segments=seg),
                          qkv.reference(h, segments=seg)),
              f"point {p!r}: qkv serve != its card reference")
    met = sched.metrics()
    med = {p: statistics.median(v) for p, v in step_ms.items()}
    report["decode"] = {
        "widths": DECODE_WIDTHS, "depth": depth,
        "points": {p or "base": list(rs) for p, rs in DECODE_POINTS.items()},
        "capacity": DECODE_CAPACITY, "bind_s": bind_s, "run_s": run_s,
        "solo_check_s": solo_s, "requests": sched_in,
        "streams": {str(u): t for u, t in streams.items()},
        "calls": calls, "tiles_per_call": tiles,
        "launches": {"cim_mbiw": dec_cim, "ring_decode": dec_ring},
        "step_ms": step_ms, "median_step_ms": med, "metrics": met}
    print(f"decode [{card}]: OLMo-1B widths, depth {depth}, points "
          f"{DECODE_POINTS}; bind {bind_s:.1f} s; {len(reqs)} requests at "
          f"capacity {DECODE_CAPACITY}: every fused stream == "
          f"decode_sequential; launches cim_mbiw {dec_cim} (= planned "
          f"tiles x calls), ring_decode {dec_ring} (= depth x calls "
          f"{calls}); qkv serve == card reference at both points",
          flush=True)
    print(f"decode metrics [{card}]: tokens/s {met['tokens_per_s']:.3f}, "
          f"{met['tokens']:.0f} tokens, {met['decode_steps']:.0f} fused "
          f"steps in {met['decode_wall_s']:.1f} s, extents "
          f"{met['extents_seen']}, median fused step "
          + ", ".join(f"{p or 'base'!r} {med[p]:.1f} ms over "
                      f"{len(step_ms[p])} steps" for p in sorted(med))
          + f"; run {run_s:.1f} s, solo checks {solo_s:.1f} s", flush=True)
    phase_s["decode"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # -- 5. times -----------------------------------------------------------
    def int_mm_inputs(planes, w, p):
        # the matmul work alone: (M, P*K) x (P*K, N) int8, padded to
        # _int_mm's needs (M > 16, K and N multiples of 8)
        m, pk = planes.shape
        n = w.shape[1]
        mp, kp, np_ = max(m, 32), -(-pk // 8) * 8, -(-n // 8) * 8
        a = torch.zeros((mp, kp), dtype=torch.int8, device=dev)
        a[:m, :pk] = planes
        b = torch.zeros((kp, np_), dtype=torch.int8, device=dev)
        b[:pk, :n] = torch.cat([w] * p, dim=0)
        return a, b

    timing = []
    shapes = [("lenet", p, t) for p, tiles in lenet_tiles.items()
              for t in tiles]
    shapes.append(("full-macro tile", (8, 1), (16384, 1152, 256)))
    # every decode row tile is 1024 deep (2048 and 8192 split evenly);
    # a col tile holds 128 channels at r_w = 2 and 64 at r_w = 4
    shapes += [("decode", p, (m, 1024, n)) for m in (1, 4)
               for p, n in (((4, 2), 128), ((8, 4), 64))]
    for label, (r_in, r_w), (m, k, n) in shapes:
        rows = label == "decode" and m > 1      # per-row beta (segments)
        shift, args = tile_inputs(m, k, n, r_in, r_w, rows)
        p = args[0].shape[1] // k
        kw = dict(plane_shift=shift, g0=0.01, r_out=8)
        reps = 50 if m * n * k * p < 5e8 else 20
        ms = cuda_ms(lambda: kern(*args, **kw), reps)
        plain = cuda_ms(
            lambda: kref.cim_mbiw_matmul_planes_ref(*args, **kw), reps)
        a, b = int_mm_inputs(args[0], args[1], p)
        lib = cuda_ms(lambda: torch._int_mm(a, b), reps)
        bnd, by = bound_ms(m, k, n, p, rows)
        dev_us = {name: device_profile(fn, 20).get("device_us")
                  for name, fn in (
                      ("kernel", lambda: kern(*args, **kw)),
                      ("plain", lambda: kref.cim_mbiw_matmul_planes_ref(
                          *args, **kw)),
                      ("library", lambda: torch._int_mm(a, b)))}
        row = {"shape": label, "r_in": r_in, "r_w": r_w, "m": m, "k": k,
               "n": n, "planes": p, "beta_rows": rows, "ms": ms,
               "plain_ms": plain,
               "library_ms": lib, "bound_ms": bnd, "bound_by": by,
               "device_us": dev_us}
        timing.append(row)
        dev_txt = ", ".join(f"{k_} {v:.1f}" if v is not None else
                            f"{k_} not measured" for k_, v in dev_us.items())
        print(f"time {tag} {label} ({r_in},{r_w}) M={m} K={k} N={n} P={p}: "
              f"kernel {ms:.4f} ms, plain {plain:.4f} ms, _int_mm "
              f"{lib:.4f} ms, bound {bnd:.4f} ms ({by}); device us per "
              f"call (profiler): {dev_txt}", flush=True)
    report["times"] = timing

    # ring_decode at the decode path's shape: the scheduler's own rings
    # (block 0's slab of the capacity-4 state), all slots valid but one row
    r, l, h, hd = (DECODE_CAPACITY, DECODE_WIDTHS["window"],
                   DECODE_WIDTHS["n_heads"],
                   DECODE_WIDTHS["d"] // DECODE_WIDTHS["n_heads"])
    g = torch.Generator(device=dev).manual_seed(2)
    sched.state["k"].normal_(generator=g)
    sched.state["v"].normal_(generator=g)
    rq = torch.randn((r, h, hd), generator=g, device=dev)
    rk, rv = sched.state["k"][:r, 0], sched.state["v"][:r, 0]
    rbias = torch.zeros((r, l), device=dev)
    rbias[0, 100:] = -1e9

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            rq[:, :, None], rk.transpose(1, 2), rv.transpose(1, 2),
            attn_mask=rbias[:, None, None, :])[:, :, 0]
    check(torch.allclose(sdpa(), ring(rq, rk, rv, rbias), rtol=1e-4,
                         atol=1e-4), "the SDPA yardstick computes another "
          "function than ring_decode")
    r_ms = cuda_ms(lambda: ring(rq, rk, rv, rbias), 50)
    r_plain = cuda_ms(lambda: rref.ring_decode_attention_ref(
        rq, rk, rv, rbias), 10)
    r_lib = cuda_ms(sdpa, 50)
    r_bnd, r_by = ring_bound_ms(r, l, h, hd)
    r_dev = {name: device_profile(fn, 10).get("device_us")
             for name, fn in (
                 ("kernel", lambda: ring(rq, rk, rv, rbias)),
                 ("plain", lambda: rref.ring_decode_attention_ref(
                     rq, rk, rv, rbias)),
                 ("library", sdpa))}
    report["ring_times"] = {"r": r, "l": l, "h": h, "hd": hd, "ms": r_ms,
                            "plain_ms": r_plain, "library_ms": r_lib,
                            "bound_ms": r_bnd, "bound_by": r_by,
                            "device_us": r_dev}
    dev_txt = ", ".join(f"{k_} {v:.1f}" if v is not None else
                        f"{k_} not measured" for k_, v in r_dev.items())
    print(f"time {tag} ring_decode R={r} L={l} H={h} hd={hd}: kernel "
          f"{r_ms:.4f} ms, plain {r_plain:.4f} ms, SDPA {r_lib:.4f} ms, "
          f"bound {r_bnd:.4f} ms ({r_by}); device us per call (profiler): "
          f"{dev_txt}", flush=True)
    phase_s["times"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()

    # one fused 4-row decode step per point under the profiler (after its
    # own warm-up step), device only: traced last, because a trace of
    # that many thousand launches leaves the profiler blind to the short
    # traces that would follow it
    prof_step = {}
    for p in model.points:
        st = model.init_state(DECODE_CAPACITY)
        toks = torch.arange(1, DECODE_CAPACITY + 1)
        prof_step[p] = device_profile(
            lambda: model.step_rows(st, toks, point=p)[1].cpu(), 1,
            cpu=False)
        del st
        pr = prof_step[p]
        dev_txt = (f"device {pr['device_us']:.0f} us (cim_mbiw "
                   f"{pr['cim_mbiw_us']:.0f}, ring_decode "
                   f"{pr['ring_decode_us']:.0f}), busy "
                   f"{100 * pr['device_busy']:.1f}% of a profiled "
                   f"{pr['wall_us'] / 1e3:.0f} ms step" if pr
                   else "device time not measured (profiler saw none)")
        print(f"decode point {p or 'base'!r} {DECODE_POINTS[p]} [{card}]: "
              f"one fused 4-row step: {dev_txt}", flush=True)
    report["decode"]["fused_step_profile"] = prof_step
    phase_s["profile"] = time.perf_counter() - t_phase

    # -- the kernels line ----------------------------------------------------
    # cim_mbiw: launches over both main paths (LeNet and decode); times are
    # per-forward sums over the (4, 2) LeNet tiles at batch 256 (fc1 runs
    # its 784-row tile twice).  ring_decode: the decode path's shape.
    fwd = [r for r in timing if r["shape"] == "lenet" and r["r_in"] == 4]
    mult = [2 if r["k"] == 784 else 1 for r in fwd]

    def fsum(key):
        return sum(c * r[key] for c, r in zip(mult, fwd))
    by = "bytes" if sum(r["bound_by"] == "bytes" for r in fwd) * 2 >= \
        len(fwd) else "operations"
    kernels = {"kernels": [{
        "name": "cim_mbiw", "route": "cuda",
        "source": "src/repro_torch/kernels/cim_mbiw/csrc/cim_mbiw.cu",
        "replaces": "src/repro/kernels/cim_mbiw/kernel.py:54",
        "launches": main_launches + dec_cim, "max_abs_err": max_err,
        "ms": fsum("ms"), "plain_ms": fsum("plain_ms"),
        "bound_ms": fsum("bound_ms"), "bound_by": by,
        "library_ms": fsum("library_ms")}, {
        "name": "ring_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attn/csrc/ring_decode.cu",
        "replaces": "src/repro/kernels/flash_attn/ops.py:197",
        "launches": dec_ring, "max_abs_err": rmax, "ms": r_ms,
        "plain_ms": r_plain, "bound_ms": r_bnd, "bound_by": r_by,
        "library_ms": r_lib}]}
    report["kernels"] = kernels
    report["launches_by_path"] = {
        "lenet": {"cim_mbiw": main_launches},
        "decode": {"cim_mbiw": dec_cim, "ring_decode": dec_ring}}
    report["total_s"] = time.perf_counter() - t_start
    report["phase_s"] = phase_s
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"total {report['total_s']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items()) + ")", flush=True)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

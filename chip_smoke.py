"""Smoke run of the PyTorch port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Phases, one line of output each, in order; any failure raises and the
script exits non-zero without printing a result:

  1. build    - compile every CUDA kernel of the port from the sources in
                this checkout (nvcc, one process per source, in parallel);
                prints build seconds and ptxas register/shared-memory use.
  2. kernels  - each kernel against its plain PyTorch version on the card,
                torch.equal over the precision grid, both beta shapes, both
                ADC modes, ragged shapes, the LeNet tiles at batch 256 and
                an FMA canary (inputs where a fused multiply-add would move
                codes).
  3. lenet    - the main path: LeNet (28x28x1 -> conv16 -> pool -> conv32 ->
                pool -> fc 1568->128 -> fc 128->10) served at full width
                through compile_program(...).bind(...).serve at (r_in, r_w)
                (4, 2) and (8, 4), weights from a seeded torch.Generator,
                images from pseudo-MNIST; logits equal the reference on the
                card and the port's CPU run bit for bit, serve_batch equals
                serve of the concatenation, and the kernel ran once per
                planned macro tile.  Median latency and images/s at 256.
  4. times    - CUDA-event times of each kernel, its plain version and the
                library matmul of the same product (torch._int_mm, a
                yardstick the port never calls), beside the least time the
                card could take (the larger of int8 ops / 1979 TOP/s and
                bytes / 3.35 TB/s, the H100 SXM's published peaks).

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
PEAK_BYTES = 3.35e12           # H100 SXM HBM3 bandwidth
LENET_BATCH = 256
REQUESTS = (1, 7, 100)
PRECISIONS = ((4, 2), (8, 4))


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


def device_profile(fn, reps: int) -> dict:
    """torch.profiler over `reps` calls: device microseconds per call (all
    kernels, those of cim_mbiw, and the eight largest by name) and the
    host wall time per call under the profiler.  Empty dict when the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"device_us": total / reps, "cim_mbiw_us": mbiw / reps,
            "wall_us": 1e6 * wall / reps,
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


def main() -> int:
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
    from repro_torch.models import cnn

    # the plain versions' products run in float64 (no TF32 there); stated
    # here all the same so no float32 yardstick can drift into TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    tag = f"[{card}]"
    report = {"card": card, "device": torch.cuda.get_device_name(0)}
    kern = kmod.cim_mbiw_matmul_planes

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

    # -- 3. LeNet served at full width (the main path) -----------------------
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

    # -- 4. times --------------------------------------------------------------
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
    for label, (r_in, r_w), (m, k, n) in shapes:
        shift, args = tile_inputs(m, k, n, r_in, r_w, False)
        p = args[0].shape[1] // k
        kw = dict(plane_shift=shift, g0=0.01, r_out=8)
        reps = 50 if m * n * k * p < 5e8 else 20
        ms = cuda_ms(lambda: kern(*args, **kw), reps)
        plain = cuda_ms(
            lambda: kref.cim_mbiw_matmul_planes_ref(*args, **kw), reps)
        a, b = int_mm_inputs(args[0], args[1], p)
        lib = cuda_ms(lambda: torch._int_mm(a, b), reps)
        bnd, by = bound_ms(m, k, n, p, False)
        dev_us = {name: device_profile(fn, 20).get("device_us")
                  for name, fn in (
                      ("kernel", lambda: kern(*args, **kw)),
                      ("plain", lambda: kref.cim_mbiw_matmul_planes_ref(
                          *args, **kw)),
                      ("library", lambda: torch._int_mm(a, b)))}
        row = {"shape": label, "r_in": r_in, "r_w": r_w, "m": m, "k": k,
               "n": n, "planes": p, "ms": ms, "plain_ms": plain,
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

    # -- 5. the kernels line ---------------------------------------------------
    # per-forward sums over the (4, 2) LeNet tiles at batch 256 (fc1 runs
    # its 784-row tile twice)
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
        "launches": main_launches, "max_abs_err": max_err,
        "ms": fsum("ms"), "plain_ms": fsum("plain_ms"),
        "bound_ms": fsum("bound_ms"), "bound_by": by,
        "library_ms": fsum("library_ms")}]}
    report["kernels"] = kernels
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

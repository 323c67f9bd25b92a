"""Run one cell of the benchmark once and print its result line.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout of the repository.  The cell's files are
found by name from BENCHMARK.json (`harness/manifest.py`).  The run
makes its inputs and weights from the seed, warms up every shape the
cell's traffic uses (set-up), measures for `--seconds` (with `--trace 1`
under the profiler, reporting the per-layer metrics instead of the
end-to-end ones), then holds what the timed path produced against the
plain reference (`reference/`).  The last line of standard output is one
JSON object; the numbers compared, each beside its limit, are the last
lines of standard error and the result's last key.

Exit codes: 0 a result was printed; 2 the manifest or a file it names is
missing; 3 no card, or fewer than the cell asks for; 4 JAX or the JAX
package was loaded.  `--control 1` puts the control (the reference in
the precision below the configuration's) in the program's place in the
comparison, on the window's own inputs, so the run reports `correct`
false where the comparison holds; the program's own reading goes to
standard error.  The benchmark's runs never ask for it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT / "src"))

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """Of `names` (default: the loaded modules), those whose top-level
    name (compared whole) is JAX's or the JAX package's."""
    names = sys.modules if names is None else names
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap


def power_limit_w() -> str:
    """The card's power limit as nvidia-smi reports it ("" if it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.stdout.strip()


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from bench.harness import manifest
    try:
        cell = manifest.cell(args.workload)
        kind = manifest.kind_module(cell.kind)
        readers = {m["name"]: manifest.metric_reader(m["name"])
                   for m in cell.per_layer} if args.trace else {}
    except manifest.ManifestError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: the cell needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from bench.harness.context import Context
    from bench.harness.result import assemble
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = Context(cell=cell, seed=args.seed, seconds=args.seconds,
                  tracing=bool(args.trace), device=torch.device("cuda", 0),
                  t_start=T_START, control=bool(args.control))
    kind.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"bench: JAX or the JAX package was loaded: {bad}",
              file=sys.stderr)
        return 4
    res = assemble(ctx, readers, torch.cuda.get_device_name(0),
                   power_limit_w())
    ctx.notes["setup_s"] = ctx.t_window - T_START
    ctx.notes["window_s"] = ctx.window_s
    for k, v in ctx.notes.items():
        print(f"note {k} = {v!r}", file=sys.stderr)
    for c in ctx.checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

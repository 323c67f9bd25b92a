"""cimcheck CLI: sweep the model zoo through the port's static verification.

Counterpart of `scripts/cimcheck.py`.  Compiles every zoo workload (the
LeNet conv chain, OLMo-1B's and phi3.5-moe's projection GEMMs; an
expert's gate_up / down GEMM is the one program its E experts share)
across the precision grid and runs every `repro_torch.analysis` pass
over the programs: the
numerics-barrier lint, noise-key injectivity, the dispatch-key budget,
plan validation.  A noise-enabled LeNet point, a sharded LeNet folded
onto the program's device, and a mixed-precision-per-layer ladder point
(budgeted across the full operating-point tag set) ride along.  On the
card the SASS pass then reads every kernel library `kernels/build.py`
builds (building them first) and holds the ADC floor free of fused
multiply-adds; on the CPU it is skipped, and the summary says so.

Programs compile for the card unless ``--device cpu`` is given.
``--full-width`` takes each arch's published widths in place of its
smoke widths.

Exit status: nonzero under --strict when any ERROR finding survives the
suppressions.  --json writes the findings (readable with
`Report.from_json`) with the per-config results.

Usage:
  python -m repro_torch.analysis --strict --json findings.json
  python -m repro_torch.analysis --device cpu --arch lenet --r-in 4 --r-w 2
  python -m repro_torch.analysis --suppress 'recompile/RC001'
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Tuple

from repro_torch.analysis import (Report, check_program, parse_suppressions,
                                  sass)
from repro_torch.core import mapping
from repro_torch.core.noise_model import NoiseConfig
from repro_torch.runtime.engine import EngineConfig, ShardingConfig
from repro_torch.runtime.program import compile_program, resolve_device

R_IN_GRID = (1, 2, 4, 8)
R_W_GRID = (1, 2, 4)
ARCHS = ("lenet", "olmo-1b", "phi3.5-moe-42b-a6.6b")

# the operating-point tags a full precision ladder serves under: RC001
# budgets the dispatch-key set they multiply into
LADDER_POINTS = ("", "quality", "balanced", "throughput")

# the sharded point's mesh, folded onto the program's device
SHARD_DEVICES = 8


def llm_specs(arch: str, r_in: int, r_w: int, m: int = 8, *,
              full_width: bool = False) -> List[mapping.LayerSpec]:
    """The decoder projection GEMMs of a zoo LLM as independent specs,
    at its smoke widths or (`full_width`) its published ones."""
    from repro_torch.configs import get_config, get_smoke_config
    c = get_config(arch) if full_width else get_smoke_config(arch)
    hd = c.resolved_head_dim
    qkv_n = (c.n_heads + 2 * c.n_kv_heads) * hd
    shapes = [(c.d_model, qkv_n),            # fused QKV
              (c.n_heads * hd, c.d_model),   # O
              (c.d_model, 2 * c.d_ff),       # fused gate_up
              (c.d_ff, c.d_model)]           # down
    return [mapping.LayerSpec(m=m, k=k, n=n, r_in=r_in, r_w=r_w)
            for k, n in shapes]


def programs_for(arch: str, r_in: int, r_w: int, device=None, *,
                 full_width: bool = False):
    """(label, program) list for one (arch, precision) sweep point."""
    out = []
    if arch == "lenet":
        from repro_torch.core.cim_layers import CIMConfig, _engine_config
        from repro_torch.models.cnn import lenet_engine_specs
        cim = CIMConfig(r_in=r_in, r_w=r_w)
        specs, acts, pools = lenet_engine_specs(8, cim=cim)
        out.append(("lenet", compile_program(
            specs, _engine_config(cim), activations=acts, pools=pools,
            device=device)))
    else:
        # the LLM projections are independent single-layer programs, as
        # models/transformer dispatches them
        for i, spec in enumerate(llm_specs(arch, r_in, r_w,
                                           full_width=full_width)):
            name = ("qkv", "o", "gate_up", "down")[i]
            out.append((f"{arch}/{name}",
                        compile_program([spec], EngineConfig(),
                                        device=device)))
    return out


def extra_points(device=None) -> List[Tuple[str, object, Tuple[str, ...]]]:
    """Noise-enabled, sharded and mixed-precision-ladder points.

    Each entry is (label, program, points): `points` is the serving
    operating-point tag set the recompile pass budgets the program's
    dispatch keys against (("",) but for the ladder point)."""
    from repro_torch.models.cnn import lenet_engine_specs
    dev = resolve_device(device)
    out = []
    specs, acts, pools = lenet_engine_specs(8)
    out.append(("lenet+noise", compile_program(
        specs, EngineConfig(noise=NoiseConfig(enabled=True)),
        activations=acts, pools=pools, device=dev), ("",)))
    # D partitions folded onto the program's device: the port's
    # counterpart of the JAX sweep's point on D host devices
    out.append((f"lenet+shard{SHARD_DEVICES}", compile_program(
        specs, EngineConfig(sharding=ShardingConfig(
            devices=SHARD_DEVICES, fold_onto=str(dev))),
        activations=acts, pools=pools, device=dev), ("",)))
    # a mixed-precision-per-layer chain, the shape of program the
    # precision planner emits for a ladder rung
    mixed = [mapping.LayerSpec(m=8, k=256, n=128, r_in=8, r_w=4),
             mapping.LayerSpec(m=8, k=128, n=64, r_in=4, r_w=2),
             mapping.LayerSpec(m=8, k=64, n=32, r_in=2, r_w=2),
             mapping.LayerSpec(m=8, k=32, n=16, r_in=2, r_w=1)]
    out.append(("mixed-ladder", compile_program(
        mixed, EngineConfig(noise=NoiseConfig(enabled=True)), device=dev),
        LADDER_POINTS))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--strict", action="store_true",
                    help="exit nonzero on any unsuppressed ERROR finding")
    ap.add_argument("--json", metavar="PATH",
                    help="write machine-readable findings JSON")
    ap.add_argument("--arch", action="append", choices=ARCHS,
                    help="restrict to one or more zoo architectures")
    ap.add_argument("--r-in", type=int, action="append",
                    choices=R_IN_GRID, help="restrict the r_in grid")
    ap.add_argument("--r-w", type=int, action="append",
                    choices=R_W_GRID, help="restrict the r_w grid")
    ap.add_argument("--max-m", type=int, default=1024,
                    help="largest request extent the recompile pass "
                         "budgets for (default 1024)")
    ap.add_argument("--suppress", action="append", default=[],
                    metavar="PASS/CODE[:reason]",
                    help="waive findings (fnmatch on pass id and code)")
    ap.add_argument("--device", default=None,
                    help='where the programs compile: "cuda" (default; '
                         'raises without a card) or "cpu"')
    ap.add_argument("--full-width", action="store_true",
                    help="the LLM projections at their published widths "
                         "instead of the smoke config's")
    ap.add_argument("--no-extra", action="store_true",
                    help="skip the noise, sharded and ladder points")
    ap.add_argument("--no-sass", action="store_true",
                    help="skip the SASS pass over the kernel libraries")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    sups = parse_suppressions(args.suppress)
    archs = tuple(args.arch) if args.arch else ARCHS
    r_ins = tuple(args.r_in) if args.r_in else R_IN_GRID
    r_ws = tuple(args.r_w) if args.r_w else R_W_GRID

    t0 = time.time()
    merged = Report(suppressions=sups)
    per_config = []
    points = [(arch, r_in, r_w) for arch in archs
              for r_in in r_ins for r_w in r_ws]
    for arch, r_in, r_w in points:
        for label, prog in programs_for(arch, r_in, r_w, dev,
                                        full_width=args.full_width):
            rep = check_program(prog, max_m=args.max_m, suppressions=sups)
            merged.merge(rep)
            per_config.append({
                "config": label, "r_in": r_in, "r_w": r_w,
                "findings": [f.to_dict() for f in rep.findings],
            })
            tag = "clean" if not rep.findings else \
                f"{len(rep.findings)} finding(s)"
            print(f"cimcheck: {label} r_in={r_in} r_w={r_w}: {tag}")
    if not args.no_extra:
        for label, prog, pts in extra_points(dev):
            rep = check_program(prog, max_m=args.max_m, suppressions=sups,
                                points=pts)
            merged.merge(rep)
            per_config.append({"config": label, "r_in": None, "r_w": None,
                               "findings": [f.to_dict()
                                            for f in rep.findings]})
            print(f"cimcheck: {label}: "
                  f"{'clean' if not rep.findings else len(rep.findings)}")
    sass_totals = None
    if args.no_sass:
        print("cimcheck: SASS pass skipped (--no-sass)")
    elif dev.type != "cuda":
        print("cimcheck: SASS pass skipped: the kernels are built and read "
              "with the card's CUDA toolkit (run without --device cpu)")
    else:
        res = sass.lint_built()        # builds any library not yet built
        merged.extend(res.findings)
        sass_totals = res.totals()
        print(f"cimcheck: SASS of {len(set(f.library for f in res.functions))}"
              f" kernel libraries: {sass_totals['functions']} functions, "
              f"{sass_totals['sinks']} floor sinks, "
              f"{sass_totals['ffma_on_slice']} FFMA on their slices")

    for f in merged.findings:
        print("cimcheck: " + f.format(), file=sys.stderr)
    ok = merged.ok()
    dt = time.time() - t0
    print(f"cimcheck: {len(points)} grid points, "
          f"{len(merged.findings)} finding(s) "
          f"({len(merged.errors())} errors, "
          f"{len(merged.suppressed)} suppressed) in {dt:.1f}s")
    if args.json:
        payload = {
            "ok": ok,
            "configs": per_config,
            "findings": [f.to_dict() for f in merged.findings],
            "suppressed": [f.to_dict() for f in merged.suppressed],
            "sass": sass_totals,
            "elapsed_s": dt,
            "device": str(dev),
        }
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2)
        print(f"cimcheck: wrote {args.json}")
    if args.strict and not ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""cimcheck for the port: plan-time static verification of CIM programs.

Counterpart of `repro/analysis`.  The passes read a compiled
`CIMProgram`'s plan, its dispatch keys and the graphs of what it runs,
and report contract violations before they cost a wrong code:

  * `barriers`    - the numerics-barrier lint on the host graph's
    rounding paths (NB001-NB003);
  * `sass`        - the same contract on the machine code the card runs:
    no fused multiply-add feeds the ADC floor (NB102);
  * `noise_keys`  - fold-chain injectivity and noise-id ranges (NK0xx);
  * `recompile`   - the dispatch-key budget and its sensitivity (RC0xx);
  * `plan_checks` - LayerSpec / ConvGeometry / macro-envelope / shard
    invariants (PV0xx).

Entry points: `check_program` (one Report over every host-side pass),
`verify_program` (raise or warn per mode: what
``compile_program(..., verify=)`` calls), `check_all_cached_programs`
(sweep the program cache, e.g. after serving warm-up), `lint_callable`
(barrier-lint any function of tensors) and `lint_sass` (the SASS pass
over a listing; `sass.lint_built` over the built kernel libraries).
``python -m repro_torch.analysis`` sweeps the model zoo over the
precision grid and writes the findings as JSON.

What the host graph is: `graph_walk.trace` records, with `make_fx` on
CPU tensors, the schedule `engine._forward` runs at the smallest bucket
rung.  A kernel call is a ctypes call on `data_ptr`s
(`kernels/cim_mbiw/kernel.py`), which no trace can see, so on the CPU
tensors of the trace every tile runs through the kernel's plain version
(the serve variants) or `engine._reference_matmul` (the reference); the
kernels themselves are covered by the SASS pass.  A check leaves no
trace in the caches: it binds outside `program.bound_for`, dispatches
nothing through the program, captures no CUDA graph, plans nothing and
launches no kernel (the trace's tensors are on the CPU), so
`engine.CAPTURE_COUNT`, `PLAN_COUNT`, the launch counters and the
program's dispatch counters do not move.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.analysis import (barriers, noise_keys, plan_checks,
                                  recompile, sass)
from repro_torch.analysis.findings import (CimcheckError, Finding, Report,
                                           Severity, Suppression,
                                           parse_suppressions)

lint_callable = barriers.lint_callable
lint_sass = sass.lint_sass

__all__ = [
    "CimcheckError", "Finding", "Report", "Severity", "Suppression",
    "barriers", "check_all_cached_programs", "check_program",
    "lint_callable", "lint_sass", "noise_keys", "parse_suppressions",
    "plan_checks", "recompile", "sass", "verify_program",
]


def _host_plan(plan):
    """The plan as the host trace runs it: a sharded plan's partitions
    folded onto the CPU (the same tiles, rows and noise slices)."""
    sh = plan.cfg.sharding
    if sh is None or sh.fold_onto == "cpu":
        return plan
    return dataclasses.replace(plan, cfg=plan.cfg.replace(
        sharding=dataclasses.replace(sh, fold_onto="cpu")))


def _traced_graphs(program, graphs: str = "all"):
    """(label, graph_walk.Graph) per dispatch variant the program can
    serve.

    Each variant is `engine._forward` recorded by `graph_walk.trace` on
    CPU tensors at the smallest bucket rung.
    ``graphs="all"`` records every variant: serve with the bind in the
    graph (weight quantization and the ABN gain traced), serve with
    segment ids, the reference, and the noise-identity path under noise.
    ``graphs="serving"`` records only what `BoundProgram.serve`
    dispatches - the bound serve (and its noise-id variant under noise) -
    the cheaper subset ``compile_program(verify=)`` runs.  A stack that
    repeats a layer is traced once per *unique* layer: the lint is local
    to a layer (the glue between layers rounds nothing), so duplicates
    would only re-record identical nodes."""
    import torch

    from repro_torch.analysis import graph_walk as gw
    from repro_torch.core import prng
    from repro_torch.runtime import engine as rt

    plan = _host_plan(program.plan)
    m = program.buckets.bucket_for(1)
    cpu = torch.device("cpu")
    unique = list(dict.fromkeys(plan.layers))
    if len(unique) < len(plan.layers):
        plans = [(f"layer{plan.layers.index(lp)}",
                  dataclasses.replace(plan, layers=(lp,)))
                 for lp in unique]
    else:
        plans = [("", plan)]
    out = []
    with torch.no_grad():
        for tag, p in plans:
            # zero weights: the values never change the recorded ops
            params = [{"w": torch.zeros(lp.spec.k, lp.spec.n),
                       "abn_log_gamma": torch.zeros(lp.spec.n),
                       "abn_beta": torch.zeros(lp.spec.n)}
                      for lp in p.layers]
            g = p.layers[0].spec.conv
            shape = (m,) + (g.spatial_in if g is not None
                            else (p.layers[0].spec.k,))
            x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
            mv = torch.tensor(m, dtype=torch.int64)
            ids = torch.arange(m, dtype=torch.int64)
            nz = rt._dispatch_noise(p, None)
            key = prng.key(0) if nz is not None else None
            binds = rt.bind_network(p, params, cpu)

            def trace(label, *, reference=False, seg=False, nid=False,
                      bound=True):
                def fn(payload, xx, mvv, segv, nidv):
                    b = payload if bound else rt.bind_network(p, payload,
                                                              cpu)
                    return rt._forward(p, b, xx, reference, key=key,
                                       noise=nz, m_valid=mvv, seg=segv,
                                       nids=nidv)
                g = gw.trace(fn, binds if bound else params, x, mv,
                             ids if seg else None, ids if nid else None)
                return (f"{label}@{tag}" if tag else label, g)

            if graphs == "serving":
                out.append(trace("serve"))
            else:
                out += [trace("serve", bound=False),
                        trace("serve+segments", seg=True),
                        trace("reference", reference=True)]
            if nz is not None:
                out.append(trace("serve+noise_ids", nid=True))
    return out


def check_program(program, *, max_m: int = 1024,
                  suppressions: Tuple[Suppression, ...] = (),
                  lint_graphs: bool = True, graphs: str = "all",
                  key_budget: int = recompile.DEFAULT_KEY_BUDGET,
                  points: Tuple[str, ...] = recompile.DEFAULT_POINTS
                  ) -> Report:
    """Run every host-side cimcheck pass over one compiled `CIMProgram`.

    Args:
      program: the compiled artifact (`compile_program(...)`).
      max_m: largest request extent the recompile pass budgets for.
      suppressions: fnmatch waivers applied to every pass's findings.
      lint_graphs: trace and barrier-lint the dispatch variants (the
        costly part; the plan-level checks run regardless).
      graphs: "all" lints every variant (segmented, reference, noise ids,
        the bind in the graph: the CLI's sweep); "serving" lints only
        the bound serve path, the inline `compile_program(verify=)`.
      key_budget: RC001 dispatch-key budget.
      points: serving operating-point tags the program dispatches under
        (precision-ladder rungs; ("",) is the single-point default).
    Returns:
      A `Report`; call `.raise_if(mode)` or inspect `.findings`.
    """
    report = Report(suppressions=tuple(suppressions))
    plan = program.plan
    report.merge(plan_checks.run(plan))
    m = program.buckets.bucket_for(1)
    report.merge(noise_keys.run(plan, m))
    report.merge(recompile.run(program, max_m=max_m, budget=key_budget,
                               points=points))
    if lint_graphs:
        for label, g in _traced_graphs(program, graphs):
            report.extend(barriers.lint_graph(g, where_prefix=label))
    return report


def verify_program(program, mode: str = "strict", **kw) -> Report:
    """`check_program` + mode enforcement; the `compile_program(verify=)`
    hook.  "strict" raises `CimcheckError` on errors, "warn" prints."""
    return check_program(program, **kw).raise_if(mode)


def check_all_cached_programs(mode: str = "warn", **kw) -> Report:
    """Sweep every program of the plan table (`program._PLAN_PROGRAMS`,
    e.g. after serving warm-up) through `check_program`; returns the
    merged Report after mode enforcement."""
    from repro_torch.runtime import program as prog_mod

    merged = Report()
    for prog in list(prog_mod._PLAN_PROGRAMS.values()):
        merged.merge(check_program(prog, **kw))
    return merged.raise_if(mode)

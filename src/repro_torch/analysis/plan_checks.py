"""Plan-validator pass (pass id ``plan``).

Counterpart of `repro/analysis/plan_checks.py` over the port's
`LayerPlan` / `NetworkPlan` (`runtime/engine.py`) and `LayerShard`
(`core/mapping.py`), with the JAX package's codes and messages.
Re-derives the LayerSpec / ConvGeometry / macro-tiling invariants the
planner (`mapping.map_layer`, `engine.plan_network`) is supposed to
enforce and checks them against a finished `NetworkPlan`.  The planner
raises on most of these at construction time; the validator exists so a
plan that was built by hand, deserialized, or mutated by a refactor is
still provably inside the hardware envelope (1152x256 macro, the 1-8b /
{1,2,4}b precision grid) before a program dispatches it.

Finding codes (all ERROR):

  * **PV001** — r_in outside 1..max_r_in (8);
  * **PV002** — r_w outside the power-of-two grid {1, 2, 4} or r_out
    outside 1..max_r_out;
  * **PV003** — row (K) tiles do not partition [0, k) contiguously;
  * **PV004** — a row tile exceeds the macro's 1152 physical rows;
  * **PV005** — a col tile exceeds the per-tile channel budget
    (n_blocks * cols_per_block / r_w columns);
  * **PV006** — conv geometry inconsistent with the GEMM view;
  * **PV007** — device shard does not cover the layer's tiles/rows;
  * **PV008** — the layer chain's feed-forward shapes do not compose.
"""
from __future__ import annotations

from typing import List

from repro_torch.analysis.findings import Finding, Report, Severity

PASS_ID = "plan"


def _err(code: str, message: str, layer=None) -> Finding:
    return Finding(pass_id=PASS_ID, code=code, severity=Severity.ERROR,
                   message=message, layer=layer)


def check_layer(lp, macro, layer_index: int) -> List[Finding]:
    """Validate one LayerPlan against the macro envelope."""
    findings: List[Finding] = []
    spec = lp.spec
    i = layer_index
    if not 1 <= spec.r_in <= macro.max_r_in:
        findings.append(_err(
            "PV001", f"r_in={spec.r_in} outside the serial-input grid "
                     f"1..{macro.max_r_in}", i))
    if spec.r_w not in (1, 2, 4) or spec.r_w > macro.max_r_w:
        findings.append(_err(
            "PV002", f"r_w={spec.r_w} outside the weight-parallel grid "
                     f"{{1, 2, 4}} (max {macro.max_r_w})", i))
    if not 1 <= spec.r_out <= macro.max_r_out:
        findings.append(_err(
            "PV002", f"r_out={spec.r_out} outside 1..{macro.max_r_out}", i))
    # row (K) tiles: contiguous exact partition of [0, k), each within
    # the macro's physical rows
    pos = 0
    for start, size in lp.k_slices:
        if start != pos or size < 1:
            findings.append(_err(
                "PV003", f"row tiles do not partition [0, {spec.k}) "
                         f"contiguously: tile ({start}, {size}) at "
                         f"offset {pos}", i))
            break
        pos = start + size
    else:
        if pos != spec.k:
            findings.append(_err(
                "PV003", f"row tiles cover [0, {pos}) but the layer has "
                         f"k={spec.k}", i))
    for _, size in lp.k_slices:
        if size > macro.n_rows:
            findings.append(_err(
                "PV004", f"row tile of {size} rows exceeds the macro's "
                         f"{macro.n_rows} physical rows", i))
            break
    # col tiles: uniform, and within the per-tile channel budget
    ch_budget = macro.n_blocks * max(1, macro.cols_per_block // spec.r_w)
    sizes = {size for _, size in lp.n_slices}
    if len(sizes) != 1:
        findings.append(_err(
            "PV005", f"col tiles are not uniform: sizes {sorted(sizes)} "
                     "(uniformity is what keeps noise draws device-count "
                     "independent)", i))
    if lp.tile_n > ch_budget:
        findings.append(_err(
            "PV005", f"col tile of {lp.tile_n} channels exceeds the "
                     f"{ch_budget}-channel budget at r_w={spec.r_w} "
                     f"({macro.n_blocks} blocks x "
                     f"{max(1, macro.cols_per_block // spec.r_w)})", i))
    if lp.n_pad < spec.n:
        findings.append(_err(
            "PV005", f"col tiles cover {lp.n_pad} channels but the layer "
                     f"has n={spec.n}", i))
    # conv geometry vs the GEMM view
    g = spec.conv
    if g is not None:
        if spec.k != g.kh * g.kw * g.c_in or spec.n != g.c_out:
            findings.append(_err(
                "PV006", f"conv geometry {g.kh}x{g.kw}x{g.c_in}->"
                         f"{g.c_out} inconsistent with GEMM view "
                         f"k={spec.k} n={spec.n}", i))
        if spec.m != g.batch * g.out_h * g.out_w:
            findings.append(_err(
                "PV006", f"conv output map {g.batch}x{g.out_h}x{g.out_w} "
                         f"inconsistent with GEMM m={spec.m}", i))
        if lp.pool > 1 and (g.out_h % lp.pool or g.out_w % lp.pool):
            findings.append(_err(
                "PV006", f"pool {lp.pool} does not divide the conv output "
                         f"{g.out_h}x{g.out_w}", i))
    # device shard coverage
    sh = lp.shard
    if sh is not None:
        if sh.kind == "col":
            if sh.devices * sh.tiles_per_device < len(lp.n_slices):
                findings.append(_err(
                    "PV007", f"col shard covers {sh.devices}x"
                             f"{sh.tiles_per_device} tiles but the layer "
                             f"has {len(lp.n_slices)}", i))
        elif sh.kind == "rows":
            if sh.devices * sh.rows_per_device < spec.m:
                findings.append(_err(
                    "PV007", f"row shard covers {sh.devices}x"
                             f"{sh.rows_per_device} rows but the layer "
                             f"has m={spec.m}", i))
        else:
            findings.append(_err(
                "PV007", f"unknown shard kind {sh.kind!r}", i))
        if not 0.0 < sh.efficiency <= 1.0:
            findings.append(_err(
                "PV007", f"shard efficiency {sh.efficiency} outside "
                         "(0, 1]", i))
    return findings


def check_plan(plan) -> List[Finding]:
    """Validate a whole NetworkPlan: per-layer envelope + chain shapes."""
    findings: List[Finding] = []
    macro = plan.cfg.macro
    for i, lp in enumerate(plan.layers):
        findings.extend(check_layer(lp, macro, i))
    from repro_torch.runtime import engine as rt
    try:
        rt._check_chain(plan.layers)
    except ValueError as e:
        findings.append(_err("PV008", str(e)))
    return findings


def run(plan) -> Report:
    """Run the plan validator; returns a Report."""
    report = Report()
    report.extend(check_plan(plan))
    return report

"""Cycle + energy model of the IMAGINE macro and accelerator (Sec. IV-V).

Cycle model - Eqs. (8), (9), (10) verbatim:
    N_stall  = 1 + N_cim + ceil(r_out*C_out / BW)             serial
    N_in     = (N_cim-1) + ceil(K*r_in*C_in / BW)             input-dominated
    N_out    = N_cim + ceil(r_out*C_out / BW) - 1             output-dominated

Timing (Sec. III): a CIM evaluation takes r_in DP+accumulate phases
(2*T_dp each), (r_w-1) inter-column sharing phases, and r_out SAR cycles.

Energy - physics-grounded switched-capacitance scaling, calibrated to the
paper's measured anchors (documented inline):
  * E_dp scales with the *connected* DPL capacitance (serial-split: fewer
    units connected -> proportionally less charge moved; Fig. 6c);
  * E_adc scales with r_out (SAR cycles) + the reference-ladder DC burn;
  * anchors: 1.2 POPS/W raw @ 8b in/out 1b w (=> E/cycle ~ 590 pJ at full
    array), 8 POPS/W raw @ 1b (=> ~74 pJ), macro 150 TOPS/W and system
    40 TOPS/W @ 8b-normalized (Table I).
All reported TOPS/W are MODEL OUTPUTS anchored to silicon measurements, not
measurements of any device this code runs on.

Counterpart of `repro/perfmodel/macro_perf.py`: plain Python over the
port's `LayerSpec`, `map_layer` and `CIMMacroConfig`, so every float
equals the JAX package's, the sharded schedule's shard columns included.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO
from repro_torch.core.mapping import LayerSpec, MacroMapping, map_layer

BW_BITS = 128                      # LMEM I/O bandwidth per cycle (Sec. IV)


@dataclasses.dataclass(frozen=True)
class CyclePerf:
    n_cim: int
    n_in: int
    n_out: int
    n_stall: int
    cycles_per_output: int         # pipelined: max(N_cim, N_in, N_out)
    cycles_serial: int


def cim_eval_time_ns(r_in: int, r_w: int, r_out: int,
                     cfg: CIMMacroConfig = DEFAULT_MACRO) -> float:
    """One macro evaluation (Sec. III.C/D phase sequence)."""
    t_inputs = r_in * 2.0 * cfg.t_dp_ns          # DP + accumulate per bit
    t_weights = max(r_w - 1, 0) * cfg.t_dp_ns    # pairwise column sharing
    t_adc = r_out * cfg.t_adc_bit_ns             # SAR decision+update
    return t_inputs + t_weights + t_adc


def cycle_model(spec: LayerSpec, *, clock_ns: float = 10.0,
                cfg: CIMMacroConfig = DEFAULT_MACRO) -> CyclePerf:
    """Eqs. (8)-(10) for one output-map value of a conv layer."""
    if spec.conv is not None:           # conv-tagged spec: exact geometry
        k = spec.conv.kh
        c_in = spec.conv.c_in
    else:
        k = spec.kernel[0]
        c_in = max(spec.k // (spec.kernel[0] * spec.kernel[1]), 1)
    n_cim = max(1, math.ceil(cim_eval_time_ns(spec.r_in, spec.r_w,
                                              spec.r_out, cfg) / clock_ns))
    n_in = (n_cim - 1) + math.ceil(k * spec.r_in * c_in / BW_BITS)
    n_out = n_cim + math.ceil(spec.r_out * spec.n / BW_BITS) - 1
    n_stall = 1 + n_cim + math.ceil(spec.r_out * spec.n / BW_BITS)
    return CyclePerf(
        n_cim=n_cim, n_in=n_in, n_out=n_out, n_stall=n_stall,
        cycles_per_output=max(n_cim, n_in, n_out),
        cycles_serial=n_in + n_stall)


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    cfg: CIMMacroConfig = DEFAULT_MACRO
    # calibrated constants (see module docstring):
    e_dp_full_pj: float = 31.0     # per input bit, full 32-unit array
    e_adc_pj: float = 28.6         # per SAR bit, all 256 columns
    e_ladder_pj: float = 14.0      # ladder DC + control, per evaluation
    e_digital_per_bit_pj: float = 0.45  # LMEM+datapath per transferred bit

    def e_dp_pj(self, n_units_on: int, r_in: int) -> float:
        """DP energy: switched capacitance of the *connected* DPL section."""
        c = self.cfg
        c_full = c.n_rows * c.c_c + c.n_units * c.c_par_per_unit + c.c_load_adc
        c_on = (n_units_on * c.rows_per_unit * c.c_c
                + n_units_on * c.c_par_per_unit + c.c_load_adc)
        return self.e_dp_full_pj * r_in * (c_on / c_full)

    def e_adc_total_pj(self, r_out: int, gamma: float = 1.0) -> float:
        # gamma>1 slightly raises ladder settle energy (compressed levels
        # are taken lower on the ladder; Fig. 18c shows a mild EE dip)
        return r_out * self.e_adc_pj + self.e_ladder_pj * (
            1.0 + 0.05 * math.log2(max(gamma, 1.0)))

    def macro_energy_pj(self, spec: LayerSpec, mp: MacroMapping,
                        gamma: float = 1.0) -> float:
        """One macro evaluation at the mapped configuration."""
        return (self.e_dp_pj(mp.units_per_tile, spec.r_in)
                + max(spec.r_w - 1, 0) * 0.25 * self.e_dp_pj(
                    mp.units_per_tile, 1)
                + self.e_adc_total_pj(spec.r_out, gamma))

    def macro_ops_per_eval(self, spec: LayerSpec, mp: MacroMapping,
                           normalize_8b: bool = False) -> float:
        """MAC*2 ops per evaluation (active rows x mapped channels)."""
        ch = min(spec.n, self.cfg.n_blocks * max(
            1, self.cfg.cols_per_block // spec.r_w))
        ops = 2.0 * mp.rows_per_tile * ch
        if normalize_8b:
            ops *= (spec.r_in / 8.0) * (spec.r_w / 8.0)
        return ops

    def macro_tops_per_watt(self, spec: LayerSpec, *, gamma: float = 1.0,
                            normalize_8b: bool = False) -> float:
        mp = map_layer(spec, self.cfg)
        e = self.macro_energy_pj(spec, mp, gamma) * 1e-12
        ops = self.macro_ops_per_eval(spec, mp, normalize_8b)
        return ops / e / 1e12

    def macro_throughput_tops(self, spec: LayerSpec, *,
                              clock_ns: float = 10.0,
                              normalize_8b: bool = False) -> float:
        mp = map_layer(spec, self.cfg)
        t = cim_eval_time_ns(spec.r_in, spec.r_w, spec.r_out, self.cfg)
        ops = self.macro_ops_per_eval(spec, mp, normalize_8b)
        return ops / (t * 1e-9) / 1e12


def schedule_report(plan, *, clock_ns: float = 10.0, pipelined: bool = True,
                    gamma: float = 1.0, program=None,
                    point=None) -> Dict[str, object]:
    """Cycle/energy estimates for a runtime engine schedule.

    `plan` is a runtime.engine.NetworkPlan (duck-typed: only
    `plan.layers[i].spec` / `.macro_evals` / `.blocks` / `.shard` and
    `plan.cfg.noise` / `.sharding` are read, so there is no perfmodel ->
    runtime import cycle).  Returns per-layer
    reports, per-precision aggregates keyed "r{r_in}x{r_w}b", schedule
    totals, and an echo of the schedule's noise settings (so a
    Monte-Carlo accuracy report and its perf numbers always carry the
    operating point they were taken at) - the model behind the paper's
    Fig. 22 precision-scaling curves, applied to an executable schedule
    instead of a lone macro.

    `program` (optional, duck-typed on `.stats()`/`.buckets`) is the
    compiled runtime.program.CIMProgram executing the plan: when given,
    the report echoes its counters - report["program"] = its stats()
    (plans_built, executables_compiled, bucket hit/miss counters, the
    dispatch routes' graphs_captured / graph_replays / eager_calls) and
    the bucket ladder config - so a perf number always carries the
    amortization state it was measured under.

    Sharded plans (plan.cfg.sharding set) additionally report the device
    partition: per-layer `rep["shard"]` carries the kind ("col" tiles vs
    "rows" of the GEMM M dim), `macro_evals_per_device` (the
    critical-path macro invocations one device performs) and
    `parallel_efficiency` (useful work / devices x per-device work - 1.0
    for an even split); the report totals gain the same two columns plus
    a "sharding" echo.

    Autotuned plans (layers with `lp.blocks` set or a non-automatic shard
    kind - see repro_torch.tuner) additionally carry `rep["tune"]`: the
    chosen cim_mbiw tile `blocks` (the heuristic's where only the kind
    was tuned) and `shard_kind` (None on a one-device plan), plus the tuner's
    predicted cost next to the heuristic schedule's cost.

    `point` (optional) names the serving operating point the schedule was
    taken at (a precision-ladder rung such as "quality"/"throughput");
    when given, report["operating_point"] echoes the name next to the
    schedule totals so downstream serving telemetry
    (`InflightScheduler.point_report`) always carries the projected
    TOPS/W of the point it dispatched.
    """
    noise = getattr(getattr(plan, "cfg", None), "noise", None)
    if noise is not None and noise.enabled:
        noise_echo = dict(dataclasses.asdict(noise))
    else:
        noise_echo = {"enabled": False}
    sharding = getattr(getattr(plan, "cfg", None), "sharding", None)
    ap = AcceleratorPerfModel(clock_ns=clock_ns)
    layers = []
    per_prec: Dict[str, Dict[str, float]] = {}
    tot_ops = tot_ops8 = tot_e = tot_t = 0.0
    tot_evals_dev = 0
    for lp in plan.layers:
        rep = ap.layer_report(lp.spec, gamma=gamma, pipelined=pipelined)
        if hasattr(lp, "macro_evals"):      # planned (k, n) tiles per M-row
            rep["macro_evals_schedule"] = lp.macro_evals
        shard = getattr(lp, "shard", None)
        if shard is not None:
            # critical-path macro invocations one device performs: col
            # sharding splits the col tiles, row sharding splits the M rows
            row_tiles = len(lp.k_slices)
            if shard.kind == "col":
                evals_dev = row_tiles * shard.tiles_per_device * lp.spec.m
            else:
                evals_dev = lp.macro_evals * shard.rows_per_device
            rep["shard"] = {
                "kind": shard.kind,
                "devices": shard.devices,
                "macro_evals_per_device": evals_dev,
                "parallel_efficiency": shard.efficiency,
            }
            tot_evals_dev += evals_dev
        blocks = getattr(lp, "blocks", None)
        tuned_kind = None
        if shard is not None and hasattr(lp, "mp"):
            auto = "col" if lp.mp.col_tiles >= shard.devices else "rows"
            if shard.kind != auto:
                tuned_kind = shard.kind
        if blocks is not None or tuned_kind is not None:
            # this layer carries an autotuned schedule: echo the chosen
            # tile/kind and the cost model's predicted-vs-heuristic cost.
            # Lazy import - repro_torch.tuner imports this module
            from repro_torch.tuner import cost as _tc
            from repro_torch.tuner import search as _ts
            cfg = getattr(plan, "cfg", None)
            macro_cfg = getattr(cfg, "macro", DEFAULT_MACRO)
            devices = shard.devices if shard is not None else 1
            heur = _ts.heuristic_choice(lp.spec, cfg, macro_cfg)
            chosen = _tc.ScheduleChoice(*(blocks or heur.blocks),
                                        shard_kind=tuned_kind)
            rep["tune"] = {
                "blocks": tuple(blocks) if blocks is not None
                else heur.blocks,
                "shard_kind": shard.kind if shard is not None else None,
                "predicted_s": _tc.layer_cost(
                    lp.spec, chosen, devices=devices,
                    macro=macro_cfg).total_s,
                "heuristic_s": _tc.layer_cost(
                    lp.spec, heur, devices=devices,
                    macro=macro_cfg).total_s,
            }
        if noise_echo["enabled"]:
            rep["noise"] = dict(noise_echo)   # per-layer copy, no aliasing
        layers.append(rep)
        ops = rep["tops"] * 1e12 * rep["time_s"]
        ops8 = rep["tops_8b_norm"] * 1e12 * rep["time_s"]
        e = rep["macro_energy_j"] + rep["digital_energy_j"]
        key = f"r{lp.spec.r_in}x{lp.spec.r_w}b"
        agg = per_prec.setdefault(
            key, {"ops": 0.0, "energy_j": 0.0, "time_s": 0.0, "layers": 0})
        agg["ops"] += ops
        agg["energy_j"] += e
        agg["time_s"] += rep["time_s"]
        agg["layers"] += 1
        tot_ops += ops
        tot_ops8 += ops8
        tot_e += e
        tot_t += rep["time_s"]
    for agg in per_prec.values():
        agg["tops"] = agg["ops"] / max(agg["time_s"], 1e-30) / 1e12
        agg["tops_per_w"] = agg["ops"] / max(agg["energy_j"], 1e-30) / 1e12
    total = {
        "time_s": tot_t,
        "energy_j": tot_e,
        "tops": tot_ops / max(tot_t, 1e-30) / 1e12,
        "tops_8b_norm": tot_ops8 / max(tot_t, 1e-30) / 1e12,
        "tops_per_w": tot_ops / max(tot_e, 1e-30) / 1e12,
        "macro_evals": plan.total_macro_evals,
    }
    report = {
        "layers": layers,
        "per_precision": per_prec,
        "noise": noise_echo,
        "total": total,
    }
    if point is not None:
        report["operating_point"] = {
            "name": str(point),
            "tops_per_w": total["tops_per_w"],
            "tops": total["tops"],
            "time_s": total["time_s"],
            "energy_j": total["energy_j"],
        }
    if program is not None:
        prog_echo: Dict[str, object] = dict(program.stats())
        buckets = getattr(program, "buckets", None)
        if buckets is not None:
            prog_echo["buckets"] = dataclasses.asdict(buckets)
        report["program"] = prog_echo
    if sharding is not None:
        # schedule-level parallel efficiency: total one-device work over
        # devices x the summed per-device critical paths.  Units:
        # total["macro_evals"] counts (row x col) tiles per M-row batch;
        # the two keys below count full macro invocations (x the GEMM-row
        # extent m), the unit of every per-layer rep["macro_evals"]
        tot_evals = sum(rep["macro_evals"] for rep in layers)
        devices = max((getattr(lp, "shard").devices
                       for lp in plan.layers
                       if getattr(lp, "shard", None) is not None),
                      default=1)
        total["macro_evals_total"] = tot_evals
        total["macro_evals_per_device"] = tot_evals_dev
        total["parallel_efficiency"] = (
            tot_evals / max(devices * tot_evals_dev, 1))
        report["sharding"] = {"devices": devices,
                              "axis": getattr(sharding, "axis", None)}
    return report


@dataclasses.dataclass(frozen=True)
class AcceleratorPerfModel:
    energy: EnergyModel = EnergyModel()
    clock_ns: float = 10.0

    def layer_report(self, spec: LayerSpec, *, gamma: float = 1.0,
                     pipelined: bool = True) -> Dict[str, float]:
        mp = map_layer(spec, self.energy.cfg)
        cyc = cycle_model(spec, clock_ns=self.clock_ns, cfg=self.energy.cfg)
        evals = mp.macro_evals * spec.m
        cycles = (cyc.cycles_per_output if pipelined else cyc.cycles_serial)
        total_cycles = evals * cycles
        e_macro = self.energy.macro_energy_pj(spec, mp, gamma) * evals
        bits_moved = spec.m * (spec.k * spec.r_in + spec.n * spec.r_out)
        e_digital = self.energy.e_digital_per_bit_pj * bits_moved
        ops = self.energy.macro_ops_per_eval(spec, mp) * evals
        ops_norm = self.energy.macro_ops_per_eval(spec, mp, True) * evals
        t_s = total_cycles * self.clock_ns * 1e-9
        rep = {
            "op": spec.op,
            "macro_evals": evals,
            "cycles_per_output": cycles,
            "total_cycles": total_cycles,
            "time_s": t_s,
            "tops": ops / t_s / 1e12,
            "tops_8b_norm": ops_norm / t_s / 1e12,
            "macro_energy_j": e_macro * 1e-12,
            "digital_energy_j": e_digital * 1e-12,
            "system_tops_per_w": ops / (e_macro + e_digital) / 1.0,
            "system_tops_per_w_8b": ops_norm / (e_macro + e_digital),
            "macro_fraction": e_macro / (e_macro + e_digital),
            "utilization": mp.utilization,
        }
        if spec.conv is not None:
            g = spec.conv
            rep["conv"] = {
                "kernel": (g.kh, g.kw), "stride": g.stride,
                "out_h": g.out_h, "out_w": g.out_w,
                "macro_evals_per_image": mp.macro_evals * g.out_h * g.out_w,
            }
        return rep

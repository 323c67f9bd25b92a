"""Analytic roofline cost model for CIM schedule candidates on the card.

Counterpart of `repro/tuner/cost.py`.  One `ScheduleChoice` - a cim_mbiw
route tile `(route, bm, bn, bk)` plus an optional shard kind - is scored
per layer on `devices` macros with the hardware tables the rest of the
port reads:

  * macro time: the IMAGINE macro's own projection, the per-device
    critical-path macro evaluations (the shard arithmetic
    `macro_perf.schedule_report` reports) x `macro_perf.cim_eval_time_ns`
    (the Sec. III.C/D phase sequence).  `macro_evals`,
    `macro_evals_per_device`, `adc_conversions`, `t_macro_s` and
    `collective_bytes` equal the JAX package's `layer_cost` on the same
    spec, choice and device count.  It is the same for every tile of
    one shard kind, so among those the ranking falls to the card term
    through `LayerCost.score()`, as the JAX package's falls to its DMA
    term.
  * card time (`t_dma_s`, in JAX's field): the Hopper route's work at
    its tile, per launch of one partition (one per row tile of the
    macro mapping over the partition's rows and its whole padded width,
    each `mp.rows_per_tile` deep, as the engine launches it), the larger
    of
      - the route's HBM bytes over `hw.H100_SXM.hbm_bw`: routes A and C
        re-read x once per column block and w once per row block;
        route B reads x once per N tile and w once, and writes and
        re-reads its int32 workspace once per K chunk; every route
        writes the int32 output once and reads gamma and beta;
      - the int8 operations of the grid (every block its whole tile)
        over the route's peak, scaled by the grid's wave fill
        ceil(blocks / 132) * 132 / blocks: route A the int8 tensor-core
        rate; route C one `__dp4a` (four multiply-adds) an int32 lane
        instruction; route B one multiply-add a lane instruction, its
        planes combined before the products.
    A partition per card runs in parallel with the others; partitions
    folded onto one card run one after another, so there the card time
    and bytes are the devices' sum.
  * collective time: the output all-gather of the shard kind, JAX's
    `collective_bytes` (each partition receives the others' int32
    slabs), over `GPUSpec.nvlink_bw` across cards or `GPUSpec.hbm_bw`
    folded onto one card (the gather is then a copy in its memory).

The score is the roofline bound max(t_macro, t_dma, t_collective); ties
break toward the lower card time and bytes and then toward the heuristic
choice (the search scores the heuristic first).

Pure integer and float geometry - no tensors - so a layer's search over a
few hundred candidates costs microseconds.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core import mapping
from repro_torch.core.hw import (CIMMacroConfig, DEFAULT_MACRO, GPUSpec,
                                 H100_SXM)
from repro_torch.kernels.cim_mbiw.kernel import Tile, plane_layout, route_for
from repro_torch.perfmodel.macro_perf import cim_eval_time_ns


@dataclasses.dataclass(frozen=True)
class ScheduleChoice:
    """One candidate schedule for a layer: a cim_mbiw route tile and a
    shard kind.

    `route` names the route ("tc", "splitk" or "cuda_core"), `bm` x `bn`
    its block and `bk` the K rows of a route B chunk (0 on routes A and
    C).  `shard_kind` is None (the automatic kind, the only one on one
    device) or an explicit "col"/"rows" for a multi-device plan.  Choices are hashable
    - they key the autotune cache entries."""
    route: str
    bm: int
    bn: int
    bk: int
    shard_kind: Optional[str] = None

    @property
    def blocks(self) -> Tile:
        """The (route, bm, bn, kc) tile, the kernel-variant knob."""
        return (self.route, self.bm, self.bn, self.bk)


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Analytic cost of one (layer, ScheduleChoice, device count) point.

    The macro counts are exact geometry (equal to macro_perf's
    layer_report); `dma_bytes` and `t_dma_s` are the card's HBM bytes
    and time of the chosen route at its tile (one partition's, or the
    sum of the partitions folded onto one card).  `total_s` is the roofline
    bound max(macro, card, collective) - the scalar the search
    minimizes."""
    macro_evals: int              # total macro invocations (all devices)
    macro_evals_per_device: int   # critical-path invocations on one device
    adc_conversions: int          # column conversions (evals x tile chans)
    dma_bytes: int                # the card's HBM bytes, all dispatches
    collective_bytes: int         # per-device all-gather bytes received
    t_macro_s: float
    t_dma_s: float
    t_collective_s: float
    total_s: float

    def score(self) -> Tuple[float, float, int]:
        """Lexicographic comparison key: roofline bound, then card time,
        then raw bytes (stable tie-breaking across candidates)."""
        return (self.total_s, self.t_dma_s, self.dma_bytes)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def kernel_dma_bytes(rows: int, k: int, n: int, tile: Optional[Tile],
                     n_planes: int) -> int:
    """HBM bytes one cim_mbiw dispatch of a (rows, k) x (k, n) tile over
    `n_planes` input planes moves at `tile` (where the shape takes the
    tile's route; the shape's own tile otherwise): routes A and C re-read
    x once per column block and w once per row block (with the gamma and
    beta rows); route B reads x once per N tile and w once, and writes
    and re-reads its int32 workspace once per K chunk; every route writes
    the int32 output once."""
    route = route_for(rows, n, k, n_planes, tile)
    out = 4 * rows * n
    if route.name == "splitk":
        n_tiles, chunks = route.grid
        return (rows * n_planes * k * n_tiles + k * n + 8 * n + out
                + 2 * 4 * rows * n * chunks)
    m_tiles, n_tiles = _cdiv(rows, route.bm), _cdiv(n, route.bn)
    return (rows * n_planes * k * n_tiles + k * n * m_tiles
            + 8 * n * m_tiles + out)


def _card_s(rows: int, k: int, n: int, tile: Optional[Tile],
            n_planes: int, gpu: GPUSpec) -> float:
    """Seconds of one dispatch: the larger of its bytes over the HBM rate
    and its grid's operations (every block its whole tile) over the
    route's peak, scaled by the wave fill ceil(blocks/SMs)*SMs/blocks."""
    route = route_for(rows, n, k, n_planes, tile)
    if route.name == "splitk":
        blocks = route.grid[0] * route.grid[1]
        # the planes are combined before the products: one multiply-add
        # an int32 lane instruction
        block_ops = 2 * rows * route.bn * route.kc
        peak = 2 * gpu.int32_ops
    else:
        blocks = _cdiv(rows, route.bm) * _cdiv(n, route.bn)
        block_ops = 2 * route.bm * route.bn * k * n_planes
        # route C: one __dp4a (four multiply-adds) an instruction
        peak = gpu.int8_ops if route.name == "tc" else 8 * gpu.int32_ops
    t_ops = _cdiv(blocks, gpu.sms) * gpu.sms * block_ops / peak
    return max(kernel_dma_bytes(rows, k, n, tile, n_planes) / gpu.hbm_bw,
               t_ops)


def layer_cost(spec: mapping.LayerSpec, choice: ScheduleChoice, *,
               devices: int = 1, macro: CIMMacroConfig = DEFAULT_MACRO,
               gpu: GPUSpec = H100_SXM, folded: bool = False) -> LayerCost:
    """Score one layer under one schedule choice on `devices` macros.

    The macro term uses the per-device critical-path eval count; the card
    term sums the route's cost over one partition's launches, one a row
    tile over its whole padded width (times the
    device count when `folded`: the partitions share one card); the
    collective term charges the output all-gather of the chosen shard
    kind over NVLink, or over the card's memory when `folded`.
    devices=1 has no collective and the full schedule on the one device,
    whatever `choice.shard_kind` says."""
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    mp = mapping.map_layer(spec, macro)
    kt, nt = mp.row_tiles, mp.col_tiles
    tile_n = math.ceil(spec.n / nt)      # uniform col-tile width
    _, n_planes = plane_layout(spec.r_in)
    evals_total = mp.macro_evals * spec.m
    if devices == 1:
        rows_local, nt_local = spec.m, nt
        evals_dev = evals_total
        coll_bytes = 0
    else:
        shard = mapping.shard_layer(spec, mp, devices,
                                    kind=choice.shard_kind)
        if shard.kind == "col":
            rows_local = spec.m
            nt_local = shard.tiles_per_device
            evals_dev = kt * nt_local * spec.m
            # all-gather of the output columns: each device receives the
            # other devices' (m, tiles_per_device * tile_n) int32 slabs
            n_tot = shard.devices * nt_local * tile_n
            coll_bytes = spec.m * (n_tot - nt_local * tile_n) * 4
        else:
            rows_local = shard.rows_per_device
            nt_local = nt
            evals_dev = mp.macro_evals * rows_local
            # all-gather of the output rows (padded col extent)
            m_tot = shard.devices * rows_local
            coll_bytes = (m_tot - rows_local) * nt * tile_n * 4
    t_eval_ns = cim_eval_time_ns(spec.r_in, spec.r_w, spec.r_out, macro)
    t_macro = evals_dev * t_eval_ns * 1e-9
    # one launch a row tile over the partition's padded width, every row
    # tile charged at mp.rows_per_tile rows (the last may be smaller):
    # monotone and upper-bounding, as the JAX model
    dispatch = (rows_local, mp.rows_per_tile, nt_local * tile_n,
                choice.blocks, n_planes)
    share = devices if folded else 1
    dma = share * kt * kernel_dma_bytes(*dispatch)
    t_dma = share * kt * _card_s(*dispatch, gpu)
    t_coll = coll_bytes / (gpu.hbm_bw if folded else gpu.nvlink_bw)
    return LayerCost(
        macro_evals=evals_total, macro_evals_per_device=evals_dev,
        adc_conversions=evals_dev * min(tile_n, spec.n),
        dma_bytes=dma, collective_bytes=coll_bytes,
        t_macro_s=t_macro, t_dma_s=t_dma, t_collective_s=t_coll,
        total_s=max(t_macro, t_dma, t_coll))

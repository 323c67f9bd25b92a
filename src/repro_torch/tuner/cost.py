"""Analytic roofline cost model for CIM schedule candidates on the card.

Counterpart of `repro/tuner/cost.py`.  One `ScheduleChoice` - a cim_mbiw
route tile `(route, bm, bn, bk)` plus an optional shard kind - is scored
per layer with the hardware tables the rest of the port reads:

  * macro time: the IMAGINE macro's own projection, macro evaluations x
    `macro_perf.cim_eval_time_ns` (the Sec. III.C/D phase sequence).
    `macro_evals`, `macro_evals_per_device`, `adc_conversions` and
    `t_macro_s` equal the JAX package's `layer_cost` on the same spec.
    It is the same for every candidate of a layer, so within a layer the
    ranking falls to the card term through `LayerCost.score()`, as the
    JAX package's falls to its DMA term.
  * card time (`t_dma_s`, in JAX's field): the Hopper route's work at
    its tile, per dispatch (one per (row tile, col tile) of the macro
    mapping, each `mp.rows_per_tile` deep, as the JAX model charges it),
    the larger of
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
  * collective time: the port plans one device (no sharding yet), so 0.

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
    C).  `shard_kind` is None (the port plans one device).  Choices are
    hashable - they key the autotune cache entries."""
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
    and time of the chosen route at its tile.  `total_s` is the roofline
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
               gpu: GPUSpec = H100_SXM) -> LayerCost:
    """Score one layer under one schedule choice.

    The macro term counts every macro evaluation of the layer (one
    device); the card term sums the route's cost over the layer's
    dispatches, `spec.m` rows each.  The port plans one device: any other
    count raises."""
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if devices != 1:
        raise NotImplementedError(
            "a sharded layer's cost waits for the sharding slice (ROADMAP "
            "Queue 1 item 4)")
    mp = mapping.map_layer(spec, macro)
    kt, nt = mp.row_tiles, mp.col_tiles
    tile_n = math.ceil(spec.n / nt)      # uniform col-tile width
    _, n_planes = plane_layout(spec.r_in)
    evals = mp.macro_evals * spec.m
    t_eval_ns = cim_eval_time_ns(spec.r_in, spec.r_w, spec.r_out, macro)
    t_macro = evals * t_eval_ns * 1e-9
    # every row tile charged at mp.rows_per_tile rows (the last may be
    # smaller): monotone and upper-bounding, as the JAX model
    dispatch = (spec.m, mp.rows_per_tile, tile_n, choice.blocks, n_planes)
    dma = nt * kt * kernel_dma_bytes(*dispatch)
    t_dma = nt * kt * _card_s(*dispatch, gpu)
    return LayerCost(
        macro_evals=evals, macro_evals_per_device=evals,
        adc_conversions=evals * min(tile_n, spec.n),
        dma_bytes=dma, collective_bytes=0,
        t_macro_s=t_macro, t_dma_s=t_dma, t_collective_s=0.0,
        total_s=max(t_macro, t_dma, 0.0))

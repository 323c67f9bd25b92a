"""Layer -> macro tiling (Sec. III.A/IV): how a GEMM or conv maps onto the
1152x256 array, how many macro invocations it costs, and how the
resulting tile schedule partitions across replicated macros (devices).

Counterpart of `repro/core/mapping.py`.

Constraints reproduced from the chip:
  * rows: K_eff = kernel_h*kernel_w*C_in bitcell rows per filter column,
    allocated in serial-split units of 36 rows (3x3 x 4 channels);
    K_eff > 1152 splits into row tiles whose partial ADC codes are summed
    digitally (with requantization) - same as any weight-stationary CIM.
  * columns: each output channel occupies r_w adjacent columns inside a
    4-column block; 64 blocks -> 64 output channels per tile (r_w<=4).
  * minimum configuration: 4 input channels (one 36-row unit) in conv mode.

Multi-macro sharding (the paper's system-level scaling assumption - the
1152x256 macro is a building block replicated for the 40 TOPS/W system
numbers): column tiles of one layer are independent macro programs, so a
bank of D macros evaluates them in parallel (`shard_layer` kind "col"); a
layer with fewer col tiles than macros instead splits its GEMM-row
dimension M = batch*out_h*out_w, every macro holding the same weights
("rows" kind - weight-stationary data parallelism).  Both choices
preserve the single-macro numerics exactly: columns and GEMM rows never
interact before the digital partial-sum recombination.

Units note: everything in this module is *integer geometry* (rows, columns,
tiles, devices) - no voltages, no code units.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO

Padding = Union[int, str, Tuple[Tuple[int, int], Tuple[int, int]]]


@dataclasses.dataclass(frozen=True)
class ConvGeometry:
    """NHWC conv geometry behind a LayerSpec's im2col GEMM view.

    The engine uses it to extract patch tiles (im2col streaming) and to
    reshape the GEMM output back to (B, out_h, out_w, c_out); the perf
    model uses it for the Eq. (8)-(10) input/output bandwidth terms."""
    h: int
    w: int
    c_in: int
    c_out: int
    kh: int
    kw: int
    stride: int
    padding: Tuple[Tuple[int, int], Tuple[int, int]]   # ((top,bot),(lt,rt))
    out_h: int
    out_w: int
    batch: int

    @property
    def spatial_in(self) -> Tuple[int, int, int]:
        """Per-sample input feature shape (H, W, C_in)."""
        return (self.h, self.w, self.c_in)


def resolve_padding(padding: Padding, kh: int, kw: int, h: int, w: int,
                    stride: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Normalize int / "SAME" / "VALID" / explicit pairs to per-edge pads."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return ((0, 0), (0, 0))
        if p == "SAME":
            pads = []
            for dim, kd in ((h, kh), (w, kw)):
                out = -(-dim // stride)
                total = max((out - 1) * stride + kd - dim, 0)
                pads.append((total // 2, total - total // 2))
            return (pads[0], pads[1])
        raise ValueError(f"padding {padding!r} not in ('SAME', 'VALID')")
    if isinstance(padding, int):
        if padding < 0:
            raise ValueError(f"padding must be >= 0, got {padding}")
        return ((padding, padding), (padding, padding))
    (pt, pb), (pl, pr) = padding
    if min(pt, pb, pl, pr) < 0:
        raise ValueError(f"padding must be >= 0, got {padding}")
    return ((int(pt), int(pb)), (int(pl), int(pr)))


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """A GEMM of shape [M, K] x [K, N] (conv layers pass K = kh*kw*C_in
    after im2col, M = batch*out_h*out_w).

    `conv` tags the spec as a convolution: the runtime engine then expects
    NHWC activations and performs the im2col itself (conv_layer_spec builds
    tagged specs); `conv is None` means a plain dense GEMM."""
    m: int
    k: int
    n: int
    r_in: int = 8
    r_w: int = 4
    r_out: int = 8
    kernel: Tuple[int, int] = (1, 1)   # (kh, kw) for conv layers
    conv: Optional[ConvGeometry] = None

    @property
    def op(self) -> str:
        """Layer kind tag: "dense" or "conv" (conv-geometry-tagged)."""
        return "dense" if self.conv is None else "conv"


@dataclasses.dataclass(frozen=True)
class MacroMapping:
    row_tiles: int          # sequential K splits (digital partial-sum adds)
    col_tiles: int          # sequential N splits (64 channels per tile)
    units_per_tile: int     # serial-split units connected per row tile
    rows_per_tile: int      # active bitcell rows per row tile
    n_dp: int               # connected rows (units * 36), sets the swing
    macro_evals: int        # row_tiles * col_tiles (per M-row batch of work)
    utilization: float      # active rows / connected rows


def map_layer(spec: LayerSpec, cfg: CIMMacroConfig = DEFAULT_MACRO
              ) -> MacroMapping:
    """Map one LayerSpec onto the macro's row/column tile grid.

    Args:
      spec: the GEMM/conv layer; spec.k sets the bitcell-row demand,
        spec.n the output-channel demand, spec.r_w the columns per channel.
      cfg:  macro geometry (1152 rows x 256 cols by default).
    Returns:
      MacroMapping with the sequential row/col tile counts, the serial-split
      unit count per row tile (adaptive swing) and the utilization.
    Raises:
      ValueError when spec.r_w exceeds the macro's column budget.
    """
    if spec.r_w > cfg.max_r_w:
        raise ValueError(f"r_w={spec.r_w} > macro max {cfg.max_r_w}")
    # one output channel per 4-col block when r_w in (3,4); two when r_w<=2
    ch_per_tile = cfg.n_blocks * max(1, cfg.cols_per_block // spec.r_w)
    col_tiles = math.ceil(spec.n / ch_per_tile)
    row_tiles = math.ceil(spec.k / cfg.n_rows)
    rows_per_tile = math.ceil(spec.k / row_tiles)
    units = cfg.units_for_rows(rows_per_tile)
    n_dp = units * cfg.rows_per_unit
    return MacroMapping(
        row_tiles=row_tiles, col_tiles=col_tiles, units_per_tile=units,
        rows_per_tile=rows_per_tile, n_dp=n_dp,
        macro_evals=row_tiles * col_tiles,
        utilization=rows_per_tile / n_dp)


def conv_layer_spec(batch: int, h: int, w: int, c_in: int, c_out: int,
                    kh: int = 3, kw: int = 3, stride: int = 1,
                    r_in: int = 8, r_w: int = 4, r_out: int = 8,
                    padding: Padding = 1) -> LayerSpec:
    """Conv-tagged LayerSpec: validates geometry and propagates stride &
    padding into out_h/out_w (and hence M = batch*out_h*out_w).

    `padding` accepts an int (symmetric), "SAME"/"VALID", or explicit
    ((top, bottom), (left, right)) pairs."""
    if min(batch, h, w, c_in, c_out, kh, kw) < 1:
        raise ValueError(
            f"conv dims must be >= 1, got batch={batch} h={h} w={w} "
            f"c_in={c_in} c_out={c_out} kh={kh} kw={kw}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    pads = resolve_padding(padding, kh, kw, h, w, stride)
    oh = (h + pads[0][0] + pads[0][1] - kh) // stride + 1
    ow = (w + pads[1][0] + pads[1][1] - kw) // stride + 1
    if oh < 1 or ow < 1:
        raise ValueError(
            f"kernel {kh}x{kw} (stride {stride}, padding {pads}) does not "
            f"fit a {h}x{w} input: out {oh}x{ow}")
    geom = ConvGeometry(h=h, w=w, c_in=c_in, c_out=c_out, kh=kh, kw=kw,
                        stride=stride, padding=pads, out_h=oh, out_w=ow,
                        batch=batch)
    return LayerSpec(m=batch * oh * ow, k=kh * kw * c_in, n=c_out,
                     r_in=r_in, r_w=r_w, r_out=r_out, kernel=(kh, kw),
                     conv=geom)


def split_k_slices(k: int, row_tiles: int) -> List[Tuple[int, int]]:
    """Even (start, size) row-tile slices of a K-dim for digital partial-sum
    accumulation.

    Args:
      k: total reduction length (bitcell rows of the layer).
      row_tiles: number of sequential macro row tiles (map_layer.row_tiles).
    Returns:
      (start, size) pairs covering [0, k); all slices have size
      ceil(k / row_tiles) except a possibly-smaller last one.
    """
    base = math.ceil(k / row_tiles)
    out, s = [], 0
    while s < k:
        size = min(base, k - s)
        out.append((s, size))
        s += size
    return out


def split_even_slices(n: int, tiles: int) -> List[Tuple[int, int]]:
    """Uniform (start, size) column-tile slices, padded to a common size.

    Sharded schedules execute col tiles SPMD across devices, which requires
    every tile to have the same shape; callers pad their column arrays to
    `tiles * size` and discard outputs at column index >= n.  The uniform
    size also makes the engine's per-tile noise draws independent of how
    many devices later execute the schedule (the bit-exactness contract of
    sharded noisy inference).

    Args:
      n: real extent (output channels of the layer).
      tiles: number of col tiles (map_layer.col_tiles).
    Returns:
      `tiles` pairs (i*size, size) with size = ceil(n / tiles); the covered
      extent tiles*size may exceed n (column padding).
    """
    size = math.ceil(n / max(tiles, 1))
    return [(i * size, size) for i in range(max(tiles, 1))]


@dataclasses.dataclass(frozen=True)
class LayerShard:
    """How one layer's tile schedule partitions across `devices` macros.

    kind "col": independent col tiles go to devices in contiguous groups
    of `tiles_per_device` (the tile count is padded up to devices *
    tiles_per_device with all-zero dummy tiles when it does not divide
    evenly).  kind "rows": the M = batch*out_h*out_w GEMM-row dimension
    splits into `rows_per_device`-row blocks instead (weights replicated).
    `efficiency` is useful work / (devices x per-device work) - 1.0 when
    the partition divides evenly."""
    devices: int            # mesh axis size D (>= 1)
    kind: str               # "col" | "rows"
    tiles_per_device: int   # col tiles per device ("col" kind, else 0)
    rows_per_device: int    # GEMM rows per device ("rows" kind, else 0)
    efficiency: float       # load balance in [1/D, 1.0]


def shard_layer(spec: LayerSpec, mp: MacroMapping,
                devices: int, kind: Optional[str] = None) -> LayerShard:
    """Partition one mapped layer across a bank of `devices` macros.

    Args:
      spec: the layer (spec.m supplies the GEMM-row extent for "rows").
      mp:   its macro mapping (col_tiles decides the default kind).
      devices: number of macros/devices (>= 1).
      kind: None selects "col" when the layer offers at least one col
        tile per device, else "rows"; an explicit "col" or "rows"
        overrides it (the schedule autotuner scores both).  Both are
        always legal: "col" with fewer col tiles than devices pads the
        tile count with all-zero dummy tiles (the efficiency shows the
        idle devices), and "rows" merely splits M.
    Returns:
      LayerShard; devices=1 degenerates to a one-device "col" plan with
      every tile on the one device.
    """
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if kind is None:
        kind = "col" if mp.col_tiles >= devices else "rows"
    if kind == "col":
        tiles_per_device = max(1, math.ceil(mp.col_tiles / devices))
        eff = mp.col_tiles / (devices * tiles_per_device)
        return LayerShard(devices=devices, kind="col",
                          tiles_per_device=tiles_per_device,
                          rows_per_device=0, efficiency=eff)
    if kind != "rows":
        raise ValueError(f"shard kind must be 'col' or 'rows', got {kind!r}")
    rows_per_device = math.ceil(spec.m / devices)
    eff = spec.m / (devices * rows_per_device) if spec.m else 1.0
    return LayerShard(devices=devices, kind="rows", tiles_per_device=0,
                      rows_per_device=rows_per_device, efficiency=eff)

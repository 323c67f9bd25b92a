"""Precision-scalable CIM inference runtime (single- and multi-macro).

Counterpart of `repro/runtime/engine.py` on the clean path: a network
described as `mapping.LayerSpec`s is *planned* into the macro's row/col
tile schedule (core/mapping.py) and *executed* through the
precision-specialized cim_mbiw kernel variants
(kernels/cim_mbiw/ops.kernel_variant_for_tile), with the chip's digital
partial-sum recombination between row tiles.  Conv-tagged specs consume
NHWC images through an im2col stage (`im2col_patches`, optionally chunked
by `EngineConfig.stream_rows`), and max-pool epilogues plus the conv ->
dense flatten are planned per layer, so a whole LeNet runs through one
plan.  The deployment API (compile once, bind weights, serve ragged
batches) is runtime/program.py.

Multi-macro sharding: the 1152x256 macro is a building block - the
paper's system-level 40 TOPS/W numbers assume it is replicated.  With
`EngineConfig(sharding=ShardingConfig(devices=D))` each layer's schedule
partitions across a mesh of D partitions (`launch/mesh.py`): layers with
at least D independent col tiles shard those (`mapping.shard_layer` kind
"col", disjoint output channels per partition), layers with fewer shard
the GEMM-row dimension M = B*OH*OW ("rows" kind, weights replicated),
and a plan may force either kind per layer (`plan_network(schedule=)`).
Each partition runs the same `_schedule_rows` body as the serial path,
on its device.  By default the mesh is the first D cards;
`ShardingConfig(fold_onto=...)` places all D partitions on one device,
the port's counterpart of the host device count the JAX package fakes
a bank of macros with.  Both kinds are bit-exact with the one-device
schedule, clean and noisy: columns and GEMM rows never interact before
the digital recombination, and the noise terms are drawn once per layer,
then padded and sliced per partition.

Numerics: the kernel path is bit-exact with the plain reference path at
every supported precision, and both are bit-exact with the JAX package.
The activation zero-point is folded into the per-channel ABN beta inside
the ADC floor (beta_eff = beta + gamma*g0*zp_dp), exactly what the chip's
signed-to-unsigned conversion + beta block does; under segment-wise
quantization (per-request isolation) the zero-point is per row, and so is
beta_eff.  Every divide of the quant/dequant chain has a tensor on the
operand's device as its divisor: PyTorch's CUDA divide by a Python scalar
multiplies by the reciprocal instead, which is not the same float.

Noise-injected mode (post-silicon studies, paper Sec. III.E/V.A): with
`EngineConfig(noise=NoiseConfig(...))` the noise model runs on every tile
- calibrated SA-offset residues (static per physical column), thermal
kT/C noise on the dp, DPL settling and MBIW charge injection as a gain,
leakage droop - through an ADC epilogue outside the kernel, which then
returns the raw integer dp (`fuse_adc=False`), so kernel and reference
stay bit-exact under one key.  Runs need a PRNG key (`core/prng`); the
thermal field of a layer is drawn in fixed `NOISE_ROW_BLOCK`-row blocks
keyed by block index (or, with noise ids, one stream per GEMM row keyed
by the row's identity), in ONE launch of the draw kernel per layer, so
chunking, bucket padding and batchmates never change a draw.  Every draw
and every float of the epilogue equals the JAX package's.

Units: `dp`/`dp_hat` are integer dot-product units, `*_codes` ADC output
codes in [0, 2^r_out), `g0` codes per dp unit at gamma=1, activations in
and out are real-valued float32.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core import abn as abn_lib
from repro_torch.core import digital_ref, mapping
from repro_torch.core import noise_model as nm
from repro_torch.core import prng
from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO
from repro_torch.core.noise_model import NO_NOISE, NoiseConfig
from repro_torch.core.quantization import (_static_reciprocal, quantize_act,
                                           quantize_weight, rounding_barrier)
from repro_torch.kernels.cim_mbiw import ops as kops
from repro_torch.kernels.cim_mbiw.kernel import Tile, check_tile
from repro_torch.kernels.cim_mbiw.ref import cim_matmul_ref
from repro_torch.kernels.prng.kernel import threefry_normal

Params = List[Dict[str, torch.Tensor]]

# incremented once per plan_network() call (a compiled program is planned
# exactly once; repeated compile_program calls must be cache hits)
PLAN_COUNT = {"n": 0}

# incremented once per CUDA-graph capture of a bound program's dispatch
# (runtime/program.py), never on a replay: the counterpart of the JAX
# package's TRACE_COUNT, flat after warm-up; "s" sums the host seconds of
# the captures (the side-stream warm-up run and the capture itself)
CAPTURE_COUNT = {"n": 0, "s": 0.0}

# incremented once per bind_network() call, "s" its host seconds (no sync:
# a bind of weights already on the card enqueues its device work, which
# later work waits on): CIMProgram.bind, program.bound_for and the
# per-call eager routes all bind through it
BIND_COUNT = {"n": 0, "s": 0.0}

# thermal kT/C draws are generated per fixed-size global GEMM-row block
# (keys fold the block index), then sliced to the live extent: the values a
# given (layer, row tile, col tile, GEMM row) sees are invariant to the
# total row extent, so batch-bucket padding and stream_rows chunking reuse
# identical draws
NOISE_ROW_BLOCK = 128

_DEPRECATION = {"warned": False}


def _warn_legacy_entry(name: str) -> None:
    """One DeprecationWarning per process for the per-call API."""
    if _DEPRECATION["warned"]:
        return
    _DEPRECATION["warned"] = True
    import warnings
    warnings.warn(
        f"{name} re-enters the engine per call; compile once with "
        "repro_torch.runtime.program.compile_program(...) (or "
        "CIMInferenceEngine.compile()) and serve through the returned "
        "CIMProgram/BoundProgram for the plan-once/serve-many path",
        DeprecationWarning, stacklevel=3)


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Multi-macro (multi-device) partitioning of the planned schedule.

    Attributes:
      devices: mesh size D; 0 means every visible CUDA device (one, the
        host, where there is none), resolved at plan time.  A dispatch
        raises when its placement has fewer devices than D.
      axis: mesh axis name (cosmetic, as in the JAX package).
      fold_onto: None places partition i on the i-th visible card (the
        CPU program's one host holds a mesh of one); a device ("cuda",
        "cuda:0", "cpu") places all D partitions on that device, which
        must be the program's.  This is the counterpart of the JAX
        package's `--xla_force_host_platform_device_count=D`, with which
        its sharded tests fake D devices on one host: the partitions run
        one after another on the one device, each on its share of the
        tiles or rows, and a clean dispatch is one CUDA graph.

    Per-layer kind selection (col tiles vs GEMM rows) is automatic - see
    `mapping.shard_layer` - unless the plan overrides it.  `devices=1` is
    a valid degenerate case that still dispatches through the sharded
    schedule on a mesh of one."""
    devices: int = 0
    axis: str = "macro"
    fold_onto: Optional[str] = None

    def resolve_devices(self) -> int:
        """Concrete mesh size: `devices`, or every visible CUDA device
        (one where there is none)."""
        if self.devices > 0:
            return self.devices
        return max(torch.cuda.device_count(), 1)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Execution configuration shared by every layer of a schedule."""
    macro: CIMMacroConfig = DEFAULT_MACRO
    adaptive_swing: bool = True      # serial-split DPL swing adaptation
    gamma_bits: int = -1             # -1: continuous gamma; >=0: HW quant
    max_gamma: float = 32.0
    bm: int = 128                    # preferred kernel block sizes, clamped
    bn: int = 128                    # per dispatched tile geometry
    bk: int = 256
    stream_rows: int = 0             # im2col streaming: GEMM rows per kernel
                                     # dispatch (0 = single dispatch)
    noise: NoiseConfig = NO_NOISE    # post-silicon equivalent noise model;
                                     # enabled -> runs require a PRNG key
    sharding: Optional[ShardingConfig] = None  # multi-macro dispatch; None
                                     # keeps the one-device path

    def replace(self, **kw) -> "EngineConfig":
        """A copy with the given fields replaced (dataclasses.replace)."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's macro-tile schedule.

    `n_slices` are *uniform* col tiles (mapping.split_even_slices): every
    tile spans `tile_n` channels and the covered extent `n_pad` may exceed
    spec.n - execution pads the column arrays and discards the excess.
    `shard` is the layer's device partition (None on one-device plans).
    `blocks` is the schedule tuner's winner, a `(route, bm, bn, kc)`
    cim_mbiw tile that every dispatch of the layer taking that route
    runs (`kernel.route_for`), or None for the shape's own tiles; a
    tile only moves where the integers are summed, never a bit."""
    spec: mapping.LayerSpec
    mp: mapping.MacroMapping
    precision: kops.KernelPrecision
    g0: float                            # unity-gain codes per dp unit
    k_slices: Tuple[Tuple[int, int], ...]  # (start, size) row tiles
    n_slices: Tuple[Tuple[int, int], ...]  # (start, size) uniform col tiles
    activation: str = "none"             # "none" | "relu"
    pool: int = 1                        # max-pool window/stride epilogue
    shard: Optional[mapping.LayerShard] = None
    blocks: Optional[Tile] = None        # tuned route tile

    @property
    def macro_evals(self) -> int:
        """Macro invocations per M-row batch: row tiles x col tiles."""
        return len(self.k_slices) * len(self.n_slices)

    @property
    def tile_n(self) -> int:
        """Channels per (uniform) col tile."""
        return self.n_slices[0][1]

    @property
    def n_pad(self) -> int:
        """Column extent covered by the uniform col tiles (>= spec.n)."""
        return len(self.n_slices) * self.tile_n

    @property
    def out_shape(self) -> Tuple[int, ...]:
        """Per-sample feature shape this layer emits (after pooling)."""
        g = self.spec.conv
        if g is None:
            return (self.spec.n,)
        return (g.out_h // self.pool, g.out_w // self.pool, g.c_out)


@dataclasses.dataclass(frozen=True)
class NetworkPlan:
    """An immutable, hashable planned schedule."""
    layers: Tuple[LayerPlan, ...]
    cfg: EngineConfig

    @property
    def total_macro_evals(self) -> int:
        """Schedule-wide macro invocations per M-row batch of work: the
        chip's, not the kernel's launches (`tile_calls`: one a row
        tile)."""
        return sum(lp.macro_evals for lp in self.layers)

    def tile_calls(self, batch: int) -> List[Tuple[int, int, int, int]]:
        """(m, n, k, planes) of every kernel call of one kernel-path
        forward over `batch` samples (the bucketed extent), in launch
        order: one a row tile, n its partition's whole padded width (the
        macro invocations of `total_macro_evals` are its col tiles); m
        counts GEMM rows (a conv layer's batch x out_h x out_w, chunked by
        cfg.stream_rows).  A sharded layer lists each partition's calls in
        partition order: "col" partitions span their tiles_per_device col
        tiles (dummy tiles included) over every row, "rows" partitions
        every col tile over their ceil(rows / D) rows (zero rows
        included)."""
        calls = []
        for lp in self.layers:
            g = lp.spec.conv
            rows = batch * (g.out_h * g.out_w if g is not None else 1)
            sh = lp.shard
            parts, n_tiles = 1, len(lp.n_slices)
            if sh is not None and sh.kind == "col":
                parts, n_tiles = sh.devices, sh.tiles_per_device
            elif sh is not None:
                parts, rows = sh.devices, -(-max(rows, 1) // sh.devices)
            chunk = self.cfg.stream_rows if self.cfg.stream_rows > 0 \
                else max(rows, 1)
            for _ in range(parts):
                for s in range(0, max(rows, 1), chunk):
                    m = min(chunk, rows - s)
                    calls += [(m, n_tiles * lp.tile_n, ksz,
                               lp.precision.n_planes)
                              for _, ksz in lp.k_slices]
        return calls


def _layer_g0(spec: mapping.LayerSpec, mp: mapping.MacroMapping,
              cfg: EngineConfig) -> float:
    macro = cfg.macro
    units = mp.units_per_tile if cfg.adaptive_swing else macro.n_units
    n_dp = units * macro.rows_per_unit
    return digital_ref.adc_gain_factor(
        spec.r_in, spec.r_w, spec.r_out, n_dp,
        macro.swing_efficiency(units), macro.alpha_adc())


def plan_layer(spec: mapping.LayerSpec, cfg: EngineConfig = EngineConfig(),
               activation: str = "none", pool: int = 1, *,
               blocks: Optional[Tile] = None,
               shard_kind: Optional[str] = None) -> LayerPlan:
    """Plan one layer: macro mapping, uniform col tiles, device partition,
    epilogues.

    Args:
      spec: the GEMM/conv layer.
      cfg: shared execution config; cfg.sharding (if set) adds the layer's
        LayerShard for cfg.sharding.resolve_devices() macros.
      activation: "none" | "relu" epilogue.
      pool: max-pool window/stride (conv layers only, 1 = none).
      blocks: optional tuned cim_mbiw tile `(route, bm, bn, kc)` (the
        schedule autotuner's winner); None keeps each dispatch's own
        tile.  Numerics-neutral at any legal value.
      shard_kind: optional explicit "col"/"rows" shard kind (requires
        cfg.sharding); None keeps mapping.shard_layer's heuristic.
    Returns:
      LayerPlan (hashable; part of the NetworkPlan).
    """
    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
    prec = kops.KernelPrecision(spec.r_in, spec.r_w, spec.r_out)
    if blocks is not None:
        blocks = tuple(blocks)
        try:
            check_tile(blocks, prec.n_planes)
        except ValueError as e:
            raise ValueError(f"blocks must be a legal cim_mbiw tile: {e}") \
                from None
    if shard_kind is not None and cfg.sharding is None:
        raise ValueError("shard_kind override requires cfg.sharding")
    if pool > 1 and spec.conv is None:
        raise ValueError("pooling epilogue requires a conv layer")
    if spec.conv is not None:
        g = spec.conv
        if spec.k != g.kh * g.kw * g.c_in or spec.n != g.c_out:
            raise ValueError(
                f"conv geometry {g} inconsistent with GEMM view "
                f"k={spec.k} n={spec.n}")
        if pool > 1 and (g.out_h < pool or g.out_w < pool):
            raise ValueError(f"pool {pool} larger than conv output "
                             f"{g.out_h}x{g.out_w}")
    mp = mapping.map_layer(spec, cfg.macro)
    shard = None
    if cfg.sharding is not None:
        shard = mapping.shard_layer(spec, mp, cfg.sharding.resolve_devices(),
                                    kind=shard_kind)
    return LayerPlan(
        spec=spec, mp=mp, precision=prec, g0=_layer_g0(spec, mp, cfg),
        k_slices=tuple(mapping.split_k_slices(spec.k, mp.row_tiles)),
        n_slices=tuple(mapping.split_even_slices(spec.n, mp.col_tiles)),
        activation=activation, pool=pool, shard=shard, blocks=blocks)


def _check_chain(layers: Sequence[LayerPlan]) -> None:
    """Feed-forward shape check across the mixed conv/dense chain: a dense
    layer's K must equal the flattened feature count of its predecessor, a
    conv layer's (h, w, c_in) must equal the predecessor's spatial output."""
    prev: Optional[LayerPlan] = None
    for i, lp in enumerate(layers):
        g = lp.spec.conv
        if prev is not None:
            out = prev.out_shape
            if g is None:
                feed = 1
                for d in out:
                    feed *= d
                if feed != lp.spec.k:
                    raise ValueError(
                        f"layer chain mismatch: layer {i-1} emits {out} "
                        f"({feed} features) but layer {i} expects "
                        f"k={lp.spec.k}")
            else:
                if len(out) != 3:
                    raise ValueError(
                        f"layer chain mismatch: conv layer {i} needs NHWC "
                        f"input but layer {i-1} emits flat {out}")
                if out != g.spatial_in:
                    raise ValueError(
                        f"layer chain mismatch: layer {i-1} emits {out} "
                        f"but conv layer {i} expects {g.spatial_in}")
                if prev.spec.conv is not None \
                        and prev.spec.conv.batch != g.batch:
                    raise ValueError(
                        f"layer chain mismatch: conv batch "
                        f"{prev.spec.conv.batch} != {g.batch} at layer {i}")
        prev = lp


def plan_network(specs: Sequence[mapping.LayerSpec],
                 cfg: EngineConfig = EngineConfig(),
                 activations: Optional[Sequence[str]] = None,
                 pools: Optional[Sequence[int]] = None, *,
                 schedule: Optional[Sequence] = None) -> NetworkPlan:
    """Plan a feed-forward network of dense and conv-tagged LayerSpecs.

    `activations`: per-layer epilogue nonlinearity; defaults to relu between
    layers and none after the last.  `pools`: per-layer max-pool
    window/stride (1 = none, conv layers only), applied after the
    activation - with the automatic conv -> dense flatten this covers the
    paper's LeNet-class CNNs.
    `schedule`: optional per-layer overrides from the autotuner - one
    `None` (heuristic) or `(blocks, shard_kind)` pair per layer, `blocks`
    a tuned cim_mbiw tile or None and `shard_kind` an explicit
    "col"/"rows" or None (see plan_layer).  Overrides never change
    numerics, only which tiles and which device partition launch the
    same sums.
    """
    specs = list(specs)
    if activations is None:
        activations = ["relu"] * (len(specs) - 1) + ["none"]
    if len(activations) != len(specs):
        raise ValueError("one activation per layer required")
    if pools is None:
        pools = [1] * len(specs)
    if len(pools) != len(specs):
        raise ValueError("one pool factor per layer required")
    if schedule is None:
        schedule = [None] * len(specs)
    if len(schedule) != len(specs):
        raise ValueError("one schedule override (or None) per layer "
                         "required")
    layers = tuple(plan_layer(
        s, cfg, act, pool,
        blocks=None if sc is None else sc[0],
        shard_kind=None if sc is None else sc[1])
        for s, act, pool, sc in zip(specs, activations, pools, schedule))
    _check_chain(layers)
    PLAN_COUNT["n"] += 1
    return NetworkPlan(layers=layers, cfg=cfg)


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def im2col_patches(x: torch.Tensor, g: mapping.ConvGeometry) -> torch.Tensor:
    """(B, H, W, C_in) -> (B, out_h, out_w, kh*kw*C_in) patch tensor whose
    trailing axis matches the engine's (K, N) weight layout: features in
    (kh, kw, c) order, the order of the JAX package's reordered
    `conv_general_dilated_patches` (F.unfold would give channel-major
    (c, kh, kw) and need the same reorder)."""
    (pt, pb), (pl, pr) = g.padding
    xp = torch.nn.functional.pad(x, (0, 0, pl, pr, pt, pb))
    s = g.stride
    cols = [xp[:, i:i + s * (g.out_h - 1) + 1:s, j:j + s * (g.out_w - 1) + 1:s, :]
            for i in range(g.kh) for j in range(g.kw)]
    return torch.stack(cols, dim=3).reshape(
        x.shape[0], g.out_h, g.out_w, g.kh * g.kw * g.c_in)


def _pad_dim(x: torch.Tensor, dim: int, size: int,
             value: float = 0.0) -> torch.Tensor:
    """Pad `dim` of `x` up to `size` with a constant (no-op if already)."""
    pad = size - x.shape[dim]
    if pad <= 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - dim) + [0, pad]
    return torch.nn.functional.pad(x, widths, value=value)


def bind_layer(lp: LayerPlan, params: Dict[str, torch.Tensor],
               cfg: EngineConfig) -> Dict[str, torch.Tensor]:
    """Precompute one layer's weight-side operands (the `bind` stage).

    Args:
      lp: the planned layer.
      params: {"w" (K, N), "abn_log_gamma" (N,), "abn_beta" (N,)}.
      cfg: shared execution config (gamma quantization settings).
    Returns:
      dict of tensors on the params' device, column-padded to the plan's
      uniform col-tile extent: "wqq" (K, n_pad) odd-integer weight codes,
      "w_scale" (N,) dequant scale, "gamma_p"/"beta_p" (n_pad,) padded ABN
      gain/offset (gamma pads with 1.0 - it divides in the dequant), and
      "g0" the plan's unity gain as a 0-d float32 (moved with the rest,
      so a dispatch makes no host-to-device copy).
    """
    wq = quantize_weight(params["w"], lp.spec.r_w, axis=0)
    gamma = abn_lib.abn_gamma(
        abn_lib.ABNParams(params["abn_log_gamma"], params["abn_beta"]),
        gamma_bits=cfg.gamma_bits, max_gamma=cfg.max_gamma)
    n_pad = lp.n_pad
    return {
        "wqq": _pad_dim(wq.q, 1, n_pad),
        "w_scale": wq.scale.reshape(-1),
        "gamma_p": _pad_dim(gamma, 0, n_pad, value=1.0),
        "beta_p": _pad_dim(params["abn_beta"], 0, n_pad),
        "g0": torch.tensor(lp.g0, dtype=torch.float32),
    }


def bind_key(lp: LayerPlan, cfg: EngineConfig) -> tuple:
    """Everything `bind_layer` and the partition placement read besides
    the params: layer plans with equal keys have equal bind products for
    equal params (plans of one layer at different batch buckets share
    one)."""
    sh = lp.shard
    return (lp.spec.k, lp.spec.n, lp.spec.r_w, lp.n_pad, lp.g0,
            cfg.gamma_bits, cfg.max_gamma, cfg.sharding,
            None if sh is None else (sh.kind, sh.devices,
                                     sh.tiles_per_device))


def engine_mesh(plan: NetworkPlan, device=None):
    """The mesh a sharded plan's partitions run on when its program runs
    on `device` (None: the host), or None for a one-device plan
    (`launch.mesh.make_engine_mesh`: the first D devices, or D folded
    onto `ShardingConfig.fold_onto`).  Raises ValueError when the
    placement has fewer devices than the plan's D."""
    sh = plan.cfg.sharding
    shards = [lp.shard for lp in plan.layers if lp.shard is not None]
    if sh is None or not shards:
        return None
    from repro_torch.launch.mesh import make_engine_mesh
    return make_engine_mesh(shards[0].devices, sh.axis,
                            device="cpu" if device is None else device,
                            fold_onto=sh.fold_onto)


def _shard_width(lp: LayerPlan) -> int:
    """Columns a layer's bind covers: the uniform col tiles, padded for a
    "col" shard up to devices * tiles_per_device tiles."""
    sh = lp.shard
    if sh is not None and sh.kind == "col":
        return max(lp.n_pad, sh.devices * sh.tiles_per_device * lp.tile_n)
    return lp.n_pad


def _place(lp: LayerPlan, b: Dict[str, torch.Tensor], mesh,
           device: Optional[torch.device]) -> Dict[str, torch.Tensor]:
    """Move one layer's bind products to `device` and, for a sharded
    layer, add "parts": one dict of {"wqq", "gamma_p", "beta_p", "g0"} per
    partition, on the partition's mesh device.  A "col" partition holds
    its contiguous group of tiles_per_device col tiles of the arrays
    padded (zero weight columns, gamma 1.0, beta 0) to the shard's width;
    a "rows" partition holds every column.  A partition on `device` holds
    views of the layer's own tensors, so a folded mesh keeps one copy of
    the weights; a partition on another card holds copies of its share."""
    width = _shard_width(lp)
    full = dict(b)
    if width > lp.n_pad:
        full["wqq"] = _pad_dim(b["wqq"], 1, width)
        full["gamma_p"] = _pad_dim(b["gamma_p"], 0, width, value=1.0)
        full["beta_p"] = _pad_dim(b["beta_p"], 0, width)
    if device is not None:
        full = {k: v.to(device) for k, v in full.items()}
    out = dict(full)
    if width > lp.n_pad:
        out["wqq"] = full["wqq"][:, :lp.n_pad]
        out["gamma_p"] = full["gamma_p"][:lp.n_pad]
        out["beta_p"] = full["beta_p"][:lp.n_pad]
    sh = lp.shard
    if sh is None:
        return out
    home = full["wqq"].device
    parts = []
    for i, pdev in enumerate(mesh.devices):
        if sh.kind == "col":
            w = sh.tiles_per_device * lp.tile_n
            cols = slice(i * w, (i + 1) * w)
            part = {"wqq": full["wqq"][:, cols],
                    "gamma_p": full["gamma_p"][cols],
                    "beta_p": full["beta_p"][cols], "g0": full["g0"]}
        else:
            part = {k: out[k] for k in ("wqq", "gamma_p", "beta_p", "g0")}
        if pdev != home:
            part = {k: v.to(pdev) for k, v in part.items()}
        parts.append(part)
    out["parts"] = tuple(parts)
    return out


def bind_network(plan: NetworkPlan, params: Params,
                 device: Optional[torch.device] = None
                 ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """bind_layer over a whole plan; the products then move to `device`
    (default: stay on the host).  A layer whose params all lie on
    `device` already binds there (no round trip through the host: an
    MoE bank at full width binds 16 experts of 26 M weights a layer);
    any other binds on the host.  The products are the same bits either
    way - bind_layer is an exact max and exactly rounded elementwise ops,
    `abn.exp2_f32` included - so every device serves with the identical
    weight codes and gamma bits.  A sharded plan's binds also carry each
    partition's padded column arrays on its mesh device (`_place`; the
    mesh is `engine_mesh(plan, device)`, which raises when too few
    devices are visible).  Validates the per-layer param count.  Each
    call counts in BIND_COUNT, with its host seconds."""
    if len(params) != len(plan.layers):
        raise ValueError(f"{len(params)} param dicts for "
                         f"{len(plan.layers)} planned layers")
    t0 = time.perf_counter()
    mesh = engine_mesh(plan, device)
    binds = []
    for lp, p in zip(plan.layers, params):
        src = torch.device("cpu")
        if device is not None and all(
                isinstance(v, torch.Tensor) and v.device == device
                for v in p.values()):
            src = device
        local = {k: torch.as_tensor(v).detach().to(src, torch.float32)
                 for k, v in p.items()}
        binds.append(_place(lp, bind_layer(lp, local, plan.cfg), mesh,
                            device))
    BIND_COUNT["n"] += 1
    BIND_COUNT["s"] += time.perf_counter() - t0
    return tuple(binds)


def _mask_pad_rows(x: torch.Tensor, m_valid) -> torch.Tensor:
    """Overwrite batch rows at index >= m_valid with a copy of row 0.

    Batch-bucketed dispatch pads the leading batch axis up to a bucket
    size; this runs before every layer so the padded rows are always
    duplicates of a live row when the dynamic activation quantization
    computes its global min/max (duplicates never move a min/max), keeping
    the valid rows bit-exact with an unpadded run.  `m_valid` is an int or
    a 0-d integer tensor on x's device (a captured dispatch's static
    buffer, which calls that share a bucket refill)."""
    idx = torch.arange(x.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    return torch.where(idx < m_valid, x, x[:1])


@dataclasses.dataclass
class _LayerNoise:
    """Per-layer noise context of one engine run.

    `offset_codes`/`droop_codes` are per padded output column (code units);
    tiles slice them.  `gain_mult` collects the deterministic INL terms
    (DPL settling, MBIW charge injection) as a multiplier on the code gain.
    `thermal` holds the kT/C noise in dp units for every (row tile, col
    tile) over the layer's full GEMM-row extent - shape (k_tiles,
    n_tiles_padded, rows, tile_n) - so slicing rows (stream chunks) never
    changes a draw, and neither does slicing or padding col tiles (device
    partitions)."""
    offset_codes: torch.Tensor       # (n_cols_padded,) code units
    droop_codes: torch.Tensor        # (n_cols_padded,) code units
    gain_mult: float                 # multiplier on gamma * g0 (a float32)
    thermal: torch.Tensor            # (KT, NT_pad, rows, tile_n) dp units

    def rows(self, sl: slice) -> "_LayerNoise":
        """The context restricted to a GEMM-row slice."""
        return dataclasses.replace(self, thermal=self.thermal[:, :, sl, :])

    def cols(self, tiles: slice, tile_n: int) -> "_LayerNoise":
        """The context restricted to a range of col tiles: their columns
        of the offsets and droop, their tiles of the thermal field."""
        c = slice(tiles.start * tile_n, tiles.stop * tile_n)
        return dataclasses.replace(
            self, offset_codes=self.offset_codes[c],
            droop_codes=self.droop_codes[c],
            thermal=self.thermal[:, tiles])

    def pad(self, tiles: int, rows: int, tile_n: int) -> "_LayerNoise":
        """The context padded with zeros to `tiles` col tiles and `rows`
        GEMM rows (the dummy tiles and rows of a partition)."""
        return dataclasses.replace(
            self, offset_codes=_pad_dim(self.offset_codes, 0,
                                        tiles * tile_n),
            droop_codes=_pad_dim(self.droop_codes, 0, tiles * tile_n),
            thermal=_pad_dim(_pad_dim(self.thermal, 1, tiles), 2, rows))

    def to(self, device: torch.device) -> "_LayerNoise":
        """The context on `device` (no copy where it already is)."""
        return dataclasses.replace(
            self, offset_codes=self.offset_codes.to(device),
            droop_codes=self.droop_codes.to(device),
            thermal=self.thermal.to(device))


def _stream_keys(lkey: Tuple[int, int], k_tiles: int, n_tiles: int,
                 m: int, row_ids: Optional[torch.Tensor],
                 row_sub: Optional[torch.Tensor]) -> Tuple[torch.Tensor,
                                                           int]:
    """The keys of one layer's draw, in one batched pass on the host:
    row 0 the SA-residue stream fold_in(lkey, 0); then, per (row tile ki,
    col tile ni) with kt = fold_in(fold_in(fold_in(lkey, 1), ki), ni),
    either one stream per NOISE_ROW_BLOCK block b (fold_in(kt, b),
    positional) or one per GEMM row (fold_in(fold_in(kt, id), sub),
    identity).  Returns ((1 + S, 2) int64 keys, streams per tile)."""
    tkey = prng.fold_in_int(lkey, 1)
    kts = torch.tensor([prng.fold_in_int(prng.fold_in_int(tkey, ki), ni)
                        for ki in range(k_tiles) for ni in range(n_tiles)],
                       dtype=torch.int64).reshape(-1, 1, 2)
    if row_ids is None:
        per = -(-max(m, 1) // NOISE_ROW_BLOCK)
        keys = prng.fold_in(kts, torch.arange(per, dtype=torch.int64))
    else:
        ids = row_ids.to("cpu", torch.int64)
        sub = (torch.zeros_like(ids) if row_sub is None
               else row_sub.to("cpu", torch.int64))
        per = ids.shape[0]
        keys = prng.fold_in(prng.fold_in(kts, ids), sub)
    res = torch.tensor([prng.fold_in_int(lkey, 0)], dtype=torch.int64)
    return torch.cat([res, keys.reshape(-1, 2)]), per


def _layer_noise(lp: LayerPlan, cfg: EngineConfig, noise: NoiseConfig,
                 gamma_p: torch.Tensor, key: Tuple[int, int], m: int,
                 row_ids: Optional[torch.Tensor] = None,
                 row_sub: Optional[torch.Tensor] = None) -> _LayerNoise:
    """Noise terms of one layer in code/dp units, where the JAX package's
    `_layer_noise` puts them.  `noise` holds float32 leaves
    (`noise_model.leaves`), `key` is the layer's key as two ints,
    `gamma_p` the column-padded ABN gain, `m` the layer's full GEMM-row
    extent (the thermal field covers it once; chunks slice it).

    `row_ids`/`row_sub` (optional, (m,) int) switch the thermal draws from
    positional row-block keys to identity keys: each GEMM row's draw folds
    its caller-assigned id and an intra-sample counter (the conv im2col
    position), so a row's noise depends only on what it is, never on
    where it sits in the batch.

    The residue stream and every thermal stream are drawn in ONE launch
    of the draw kernel, at the longer of the two lengths: a threefry
    stream's first n values do not depend on how many are drawn (the
    counter is the flat index), so each reads the prefix it needs."""
    macro, spec = cfg.macro, lp.spec
    dev = gamma_p.device
    units = lp.mp.units_per_tile if cfg.adaptive_swing else macro.n_units
    tsz = lp.tile_n
    k_tiles, n_tiles = len(lp.k_slices), len(lp.n_slices)
    keys, per = _stream_keys(key, k_tiles, n_tiles, m, row_ids, row_sub)
    span = tsz * (NOISE_ROW_BLOCK if row_ids is None else 1)
    z = threefry_normal(keys.to(dev), max(span, macro.n_cols))
    # static per-physical-column SA offsets after 7b calibration, shared
    # across col tiles (the macro is reused sequentially)
    raw_v = nm.sa_offsets_from_normal(z[0, :macro.n_cols], noise)
    res_v = nm.column_residues_from_offsets(raw_v, spec.n, spec.r_w, noise,
                                            macro)
    res_v = _pad_dim(res_v, 0, gamma_p.shape[0])
    lsb0_v = macro.alpha_adc() * macro.vddh / 2.0 ** (spec.r_out - 1)
    # volts -> codes: a static f32 reciprocal, as the JAX package
    inv_lsb0 = _static_reciprocal(lsb0_v)
    offset_codes = rounding_barrier(gamma_p * res_v * inv_lsb0)
    # leakage droop on V_acc, attenuated by the weight-parallel combination
    droop_v = nm.leakage_droop(spec.r_in, macro.t_dp_ns, noise) \
        * (1.0 - 2.0 ** (-spec.r_w))
    # the scalars are float32 values on the host; as Python floats they
    # multiply on the device with no copy (a product rounds them to
    # float32, which they are)
    droop_codes = rounding_barrier(gamma_p * float(droop_v) * inv_lsb0)
    settle = nm.settle_fraction(units, macro.t_dp_ns, noise)
    ci = nm.charge_injection_gain(spec.r_in, noise, macro)
    sigma_dp = nm.thermal_sigma_dp(noise, spec.r_out, lp.g0)
    field = z[1:, :span].reshape(k_tiles, n_tiles, per * span // tsz, tsz)
    thermal = field[:, :, :m] * float(sigma_dp)
    return _LayerNoise(offset_codes=offset_codes, droop_codes=droop_codes,
                       gain_mult=float(settle * (1.0 + ci)),
                       thermal=thermal)


def _noise_adc_code(lp: LayerPlan, dp: torch.Tensor, gamma_t: torch.Tensor,
                    beta_eff: torch.Tensor, nctx: _LayerNoise,
                    n_slice: Tuple[int, int],
                    thermal: torch.Tensor) -> torch.Tensor:
    """ADC conversion of one macro tile's raw dp with the noise terms
    applied before the floor - the engine-side mirror of fakequant's
    adc_quantize(dp + thermal, gain, beta + offsets).  `thermal` is the
    tile's kT/C slice (dp units, row-aligned)."""
    ns, ne = n_slice
    dp = dp.to(torch.float32) + thermal
    mid = 2.0 ** (lp.spec.r_out - 1)
    # products by Python scalars round them to float32 first, as JAX's
    # weak-typed scalars: gamma * f32(g0) * gain_mult * dp, step by step
    code = torch.floor(mid + rounding_barrier(gamma_t * lp.g0
                                              * float(nctx.gain_mult) * dp)
                       + beta_eff
                       + nctx.offset_codes[ns:ne] - nctx.droop_codes[ns:ne])
    return torch.clamp(code, 0.0, 2.0 ** lp.spec.r_out - 1.0).to(
        torch.int32)


def _tile_schedule(lp: LayerPlan, q_rows: torch.Tensor, zp: torch.Tensor,
                   bind: Dict[str, torch.Tensor], *, matmul,
                   nctx: Optional[_LayerNoise] = None) -> torch.Tensor:
    """One block of GEMM rows through the (k, n) tile schedule.

    `matmul` evaluates one row tile over every col tile at once (kernel
    variant or plain oracle) and returns int32 ADC codes - or the raw
    int32 dp when a noise context is given, whose ADC conversion (with
    the noise terms and each col tile's thermal slice) then runs here.
    With a `matmul.prepare` (the kernel's plane split) each row tile's
    activations are prepared once and `matmul` takes them prepared.  `zp`
    is the activation zero-point in code units: a scalar, or per row
    (rows, 1) under segment-wise quantization, which makes the folded ADC
    offset beta_eff per GEMM row (rows, n).  `bind` holds the layer's bind
    products.  Returns dp_hat (rows, n_pad) in dp units.

    A row tile's work (the launch, the zero-point fold, the dequant and
    the digital recombination) runs once over all its col tiles: col
    tiles share no sum and each column has its own ADC, so the same
    operations in the same order for every element as a macro tile at a
    time, the same bits, with a few launches a row tile in place of a few
    a macro tile."""
    mid = 2.0 ** (lp.spec.r_out - 1)
    g0 = lp.g0
    tsz = lp.tile_n
    wqq, gamma, beta = bind["wqq"], bind["gamma_p"], bind["beta_p"]
    gain = rounding_barrier(gamma * bind["g0"])
    prepare = getattr(matmul, "prepare", None)
    acc = torch.zeros((q_rows.shape[0], wqq.shape[1]), dtype=torch.float32,
                      device=q_rows.device)
    for ki, (ks, ksz) in enumerate(lp.k_slices):
        ke = ks + ksz
        xq = q_rows[:, ks:ke]
        if prepare is not None:
            xq = prepare(xq)
        # zero-point: x = q*s + z -> z*colsum is per-channel constant,
        # folded into the ABN offset inside the ADC floor (the column sums
        # are integers, exact in any order)
        zp_dp = zp * torch.sum(wqq[ks:ke], dim=0)
        beta_eff = beta + rounding_barrier(gain * zp_dp)
        codes = matmul(xq, wqq[ks:ke], gamma, beta_eff, g0)
        if nctx is not None:
            tiles = [_noise_adc_code(lp, codes[:, ns:ns + tsz],
                                     gamma[ns:ns + tsz],
                                     beta_eff[..., ns:ns + tsz], nctx,
                                     (ns, ns + tsz), nctx.thermal[ki, ni])
                     for ni, ns in enumerate(range(0, wqq.shape[1], tsz))]
            codes = tiles[0] if len(tiles) == 1 else torch.cat(tiles, -1)
        # digital partial-sum recombination in dp units; dequantizing
        # against the *raw* beta keeps the zero-point contribution in
        # dp_hat (the divisor `gain` is a device tensor)
        acc = acc + (codes.to(torch.float32) + 0.5 - mid
                     - beta[None, :]) / gain[None, :]
    return acc


def _schedule_rows(lp: LayerPlan, cfg: EngineConfig, q_rows: torch.Tensor,
                   zp: torch.Tensor, bind: Dict[str, torch.Tensor], *,
                   matmul,
                   nctx: Optional[_LayerNoise] = None) -> torch.Tensor:
    """Stream `q_rows` through the tile schedule in cfg.stream_rows chunks
    (the im2col streaming stage).  Quantization stays global (or
    per-segment - `zp` is then per-row (M, 1) and chunks alongside the
    rows), and the noise context holds the thermal field over all rows,
    so chunking is bit-invariant, with or without noise."""
    m = q_rows.shape[0]
    chunk = cfg.stream_rows if cfg.stream_rows > 0 else max(m, 1)
    parts = []
    for s in range(0, max(m, 1), chunk):
        sl = slice(s, s + chunk)
        parts.append(_tile_schedule(
            lp, q_rows[sl], zp if zp.dim() == 0 else zp[sl], bind,
            matmul=matmul,
            nctx=nctx.rows(sl) if nctx is not None else None))
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


def _sharded_schedule(lp: LayerPlan, cfg: EngineConfig,
                      q_rows: torch.Tensor, zp: torch.Tensor,
                      bind: Dict[str, torch.Tensor], *, matmul,
                      nctx: Optional[_LayerNoise]) -> torch.Tensor:
    """Dispatch one layer's tile schedule across its mesh partitions
    (bind["parts"], one per partition, on the partition's device).

    kind "col": the uniform col tiles (padded up to devices *
    tiles_per_device with all-zero dummy tiles) go to the partitions in
    contiguous groups - each runs `_schedule_rows` on its tiles over every
    row, and the output columns concatenate in partition order.  kind
    "rows": the GEMM rows (zero-padded to a multiple of the device count)
    split into equal blocks instead, every partition holding every col
    tile; a per-row zero-point splits with its rows, a scalar one is
    shared.  The body is the same `_schedule_rows` the serial path runs
    (the tuned tile and route choice included), and the noise terms are
    drawn once for the layer, then padded and sliced, so both kinds are
    bit-exact with the one-device schedule: padding only adds discarded
    rows and columns.  A partition on another device gets its rows (and
    noise share) moved there and its output moved back to the rows'
    device.  Returns dp_hat (m, padded columns); the caller slices the
    columns."""
    shard, m = lp.shard, q_rows.shape[0]
    parts, home = bind["parts"], q_rows.device

    def run(part, q, z, nl):
        dev = part["wqq"].device
        nl = None if nl is None else nl.to(dev)
        y = _schedule_rows(lp, cfg, q.to(dev), z.to(dev), part,
                           matmul=matmul, nctx=nl)
        return y.to(home)

    if shard.kind == "col":
        tpd = shard.tiles_per_device
        if nctx is not None:
            nctx = nctx.pad(shard.devices * tpd, m, lp.tile_n)
        return torch.cat([
            run(part, q_rows, zp, None if nctx is None else nctx.cols(
                slice(i * tpd, (i + 1) * tpd), lp.tile_n))
            for i, part in enumerate(parts)], dim=1)

    per = -(-max(m, 1) // shard.devices)
    q_pad = _pad_dim(q_rows, 0, per * shard.devices)
    zp_pad = zp if zp.dim() == 0 else _pad_dim(zp, 0, per * shard.devices)
    if nctx is not None:
        nctx = nctx.pad(nctx.thermal.shape[1], per * shard.devices,
                        lp.tile_n)
    outs = []
    for i, part in enumerate(parts):
        sl = slice(i * per, (i + 1) * per)
        outs.append(run(part, q_pad[sl], zp if zp.dim() == 0 else zp_pad[sl],
                        None if nctx is None else nctx.rows(sl)))
    return torch.cat(outs, dim=0)[:m]


def _layer_tiles(lp: LayerPlan, bind: Dict[str, torch.Tensor],
                 x2: torch.Tensor, cfg: EngineConfig, *, matmul,
                 key: Optional[Tuple[int, int]] = None,
                 noise: Optional[NoiseConfig] = None,
                 sharded: bool = False,
                 seg_rows: Optional[torch.Tensor] = None,
                 nid_rows: Optional[torch.Tensor] = None,
                 sub_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run one layer's tile schedule over (M, K) GEMM rows: activation
    quantization, the noise context, the tile schedule (serially in stream
    chunks, or with `sharded` across the layer's mesh partitions -
    numerically identical paths), dequant and activation.

    `seg_rows` (optional, (M,) int) switches the activation quantization
    to per-segment statistics: the zero-point becomes per-row and folds
    into a per-row beta_eff inside the ADC floor, so rows of different
    segments never share swing state.  `nid_rows`/`sub_rows` key the
    thermal draws by row identity instead of position (_layer_noise)."""
    if seg_rows is None:
        aq = quantize_act(x2, lp.spec.r_in)
    else:
        aq = quantize_act(x2, lp.spec.r_in, segment_ids=seg_rows,
                          num_segments=x2.shape[0])
    zp = aq.zero / aq.scale
    nctx = (_layer_noise(lp, cfg, noise, bind["gamma_p"], key, x2.shape[0],
                         row_ids=nid_rows, row_sub=sub_rows)
            if noise is not None else None)
    if sharded and lp.shard is not None:
        dp_hat = _sharded_schedule(lp, cfg, aq.q, zp, bind, matmul=matmul,
                                   nctx=nctx)
    else:
        dp_hat = _schedule_rows(lp, cfg, aq.q, zp, bind, matmul=matmul,
                                nctx=nctx)
    y = dp_hat[:, :lp.spec.n] * aq.scale * bind["w_scale"]
    if lp.activation == "relu":
        y = torch.relu(y)
    elif lp.activation != "none":
        raise ValueError(f"unknown activation {lp.activation!r}")
    return y


def _run_layer(lp: LayerPlan, bind: Dict[str, torch.Tensor],
               x: torch.Tensor, cfg: EngineConfig, *, matmul,
               key: Optional[Tuple[int, int]] = None,
               noise: Optional[NoiseConfig] = None,
               sharded: bool = False,
               seg: Optional[torch.Tensor] = None,
               nids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One planned layer end-to-end: im2col (conv), tile schedule,
    activation, pooling, and the reshape back to the next layer's view.

    `seg`/`nids` are per *batch sample* (B,) segment and noise-identity
    ids; a conv layer's im2col expansion repeats them across the sample's
    out_h*out_w GEMM rows (plus an intra-sample counter for the noise
    draws), a dense layer uses them as they are."""
    g = lp.spec.conv
    sub_rows = None
    if g is not None:
        if x.dim() != 4 or tuple(x.shape[1:]) != g.spatial_in:
            raise ValueError(
                f"conv layer expects (B, {g.h}, {g.w}, {g.c_in}) "
                f"activations, got {tuple(x.shape)}")
        b = x.shape[0]
        rep = g.out_h * g.out_w
        x2 = im2col_patches(x, g).reshape(b * rep, lp.spec.k)
        # an expand, not repeat_interleave: no host copy of the repeats
        seg_rows = None if seg is None else seg[:, None].expand(
            b, rep).reshape(-1)
        nid_rows = None if nids is None else torch.repeat_interleave(nids,
                                                                     rep)
        if nids is not None:
            sub_rows = torch.arange(rep, dtype=torch.int64).repeat(b)
    else:
        x2 = x.reshape(x.shape[0], -1)        # conv -> dense flatten (NHWC)
        if x2.shape[-1] != lp.spec.k:
            raise ValueError(f"dense layer expects {lp.spec.k} features, "
                             f"got {x2.shape[-1]} from {tuple(x.shape)}")
        seg_rows, nid_rows = seg, nids
    y = _layer_tiles(lp, bind, x2, cfg, matmul=matmul, key=key, noise=noise,
                     sharded=sharded, seg_rows=seg_rows, nid_rows=nid_rows,
                     sub_rows=sub_rows)
    if g is not None:
        y = y.reshape(b, g.out_h, g.out_w, g.c_out)
    if lp.pool > 1:
        p = lp.pool
        oh, ow = g.out_h // p, g.out_w // p
        y = y[:, :oh * p, :ow * p].reshape(b, oh, p, ow, p, g.c_out)
        y = torch.amax(y, dim=(2, 4))
    return y


def _kernel_matmul(lp: LayerPlan, cfg: EngineConfig):
    # under noise the kernel dispatches in raw-dp mode; the noise ADC
    # epilogue in _tile_schedule owns the conversion
    fuse = not cfg.noise.enabled

    def variant(rows, k, n):
        return kops.kernel_variant_for_tile(
            lp.precision, rows, k, n, bm=cfg.bm, bn=cfg.bn, bk=cfg.bk,
            fuse_adc=fuse, tile=lp.blocks)

    def matmul(x_planes, wqt, gamma_t, beta_t, g0):
        fn = variant(x_planes.shape[0], wqt.shape[0], wqt.shape[1])
        return fn.on_planes(x_planes, wqt, gamma_t, beta_t, g0)
    # the plane split depends on the precision alone: one a row tile
    matmul.prepare = lambda xq: variant(xq.shape[0], xq.shape[1], 1).split(
        xq)
    return matmul


def _reference_matmul(lp: LayerPlan, cfg: EngineConfig):
    if cfg.noise.enabled:
        def matmul(xq, wqt, gamma_t, beta_t, g0):
            # raw integer dp: the shared noise ADC epilogue runs outside,
            # so kernel and reference stay bit-exact under a common key
            return digital_ref.int_matmul(xq, wqt)
        return matmul

    def matmul(xq, wqt, gamma_t, beta_t, g0):
        # the plain oracle keeps the ADC floor expression in float-op
        # lockstep with the kernel epilogue (bit-exactness contract)
        return cim_matmul_ref(xq, wqt, gamma_t, beta_t, g0=g0,
                              r_out=lp.spec.r_out)
    return matmul


def _forward(plan: NetworkPlan, binds: Sequence[Dict[str, torch.Tensor]],
             x: torch.Tensor, reference: bool,
             key=None, noise: Optional[NoiseConfig] = None,
             m_valid=None,
             seg: Optional[torch.Tensor] = None,
             nids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole schedule over a canonical batch: (B, H, W, C) images for a
    conv-first plan, (B, K0) rows for a dense-first one.  `m_valid` (an
    int, or a 0-d integer tensor on the device) marks the live rows of a
    bucket-padded batch (pad rows are re-pinned to copies of row 0 before
    every layer).  `seg` ((B,) int, optional) are
    the per-sample segment ids of segment-wise activation quantization.

    `noise` is the run's resolved operating point (`_dispatch_noise`:
    None runs clean) and `key` its PRNG key; layer i draws under
    fold_in(key, i).  `nids` ((B,) int, optional, on the host) key the
    thermal draws by sample identity.

    A sharded plan's kernel path runs each layer across its mesh
    partitions (`_sharded_schedule`); the reference always runs the
    serial schedule."""
    if plan.cfg.noise.enabled and key is None:
        raise ValueError(
            "noise-injected engine run requires a PRNG key: pass key= to "
            "the program's serve/run (or plan with noise=NO_NOISE for the "
            "deterministic deployed path)")
    xc = x.to(torch.float32)
    if seg is not None and seg.shape[0] != xc.shape[0]:
        raise ValueError(f"segments extent {seg.shape[0]} != canonical "
                         f"batch extent {xc.shape[0]}")
    if nids is not None and nids.shape[0] != xc.shape[0]:
        raise ValueError(f"noise_ids extent {nids.shape[0]} != canonical "
                         f"batch extent {xc.shape[0]}")
    noisy = noise is not None
    if noisy:
        base = prng.key_ints(key)
        noise = nm.leaves(noise)
    mk = _reference_matmul if reference else _kernel_matmul
    sharded = (not reference) and plan.cfg.sharding is not None
    for i, (lp, bind) in enumerate(zip(plan.layers, binds)):
        if m_valid is not None:
            xc = _mask_pad_rows(xc, m_valid)
        lkey = prng.fold_in_int(base, i) if noisy else None
        xc = _run_layer(lp, bind, xc, plan.cfg, matmul=mk(lp, plan.cfg),
                        key=lkey, noise=noise, sharded=sharded, seg=seg,
                        nids=nids)
    return xc


def _dispatch_noise(plan: NetworkPlan,
                    noise: Optional[NoiseConfig]) -> Optional[NoiseConfig]:
    """Resolve the run's noise operating point.

    None -> the planned point (or no noise at all under NO_NOISE plans);
    an explicit NoiseConfig overrides the planned numeric terms, but must
    agree on `enabled` (that flag switches the kernel between fused ADC
    and raw dp - replan to change modes)."""
    base = plan.cfg.noise
    if noise is None:
        return base if base.enabled else None
    if bool(noise.enabled) != bool(base.enabled):
        raise ValueError(
            f"noise override enabled={noise.enabled} conflicts with the "
            f"planned enabled={base.enabled}; replan with "
            "EngineConfig(noise=...) to switch modes")
    return noise if noise.enabled else None


def init_network_params(plan: NetworkPlan,
                        source: Union[torch.Generator, torch.Tensor]
                        ) -> Params:
    """Distribution-aware per-layer parameters for a planned network
    (core/cim_layers init, one {"w", "abn_log_gamma", "abn_beta"} dict per
    layer in plan order).  `source` is a `torch.Generator` (weights drawn
    on its device, in layer order) or a `core/prng` key, which draws the
    JAX package's parameters bit for bit on the key's device: one
    `split` per layer, the layer's weights from the second half."""
    from repro_torch.core.cim_layers import CIMConfig, init_cim_linear
    cfg = plan.cfg
    keyed = not isinstance(source, torch.Generator)
    params = []
    for lp in plan.layers:
        if keyed:
            source, sub = prng.split(source)
        else:
            sub = source
        lcfg = CIMConfig(
            r_in=lp.spec.r_in, r_w=lp.spec.r_w, r_out=lp.spec.r_out,
            adaptive_swing=cfg.adaptive_swing,
            gamma_bits=cfg.gamma_bits, max_gamma=cfg.max_gamma,
            macro=cfg.macro)
        params.append(init_cim_linear(sub, lp.spec.k, lp.spec.n, cfg=lcfg))
    return params


# ---------------------------------------------------------------------------
# the per-call entry points (the JAX package's legacy API)
# ---------------------------------------------------------------------------

def run_network(plan: NetworkPlan, params: Params, x: torch.Tensor,
                key=None, noise: Optional[NoiseConfig] = None, *,
                segments: Optional[torch.Tensor] = None,
                device=None) -> torch.Tensor:
    """Execute the planned schedule through the cim_mbiw kernel routes.

    .. deprecated:: the per-call entry point; it keeps working (backed by
       the program cache of runtime/program.py: repeated calls at one plan
       reuse one program) but new code compiles once with
       `compile_program` and serves through the CIMProgram/BoundProgram.

    Args:
      plan: the NetworkPlan; with plan.cfg.sharding set each layer runs
        across its mesh partitions.
      params: one {"w", "abn_log_gamma", "abn_beta"} dict per layer.
      x: (..., K0) activations for a dense-first plan, or (..., H, W,
        C_in) NHWC images for a conv-first plan.
      key: `core/prng` key of a noise-enabled plan (ignored under
        NO_NOISE).
      noise: optional NoiseConfig overriding the planned numeric terms.
      segments: optional (B,) per-sample segment ids (segment-wise
        activation quantization).
      device: where it runs; None means CUDA (raises without a card).
    Returns:
      (..., N_last) activations, or (..., out_h, out_w, C_out) if the
      last layer is a conv; on the program's device.
    """
    _warn_legacy_entry("run_network")
    from repro_torch.runtime.program import program_for_plan
    return program_for_plan(plan, device=device).run(
        params, x, key, noise, segments=segments)


def run_network_reference(plan: NetworkPlan, params: Params,
                          x: torch.Tensor, key=None,
                          noise: Optional[NoiseConfig] = None, *,
                          device=None) -> torch.Tensor:
    """The plain digital oracle of the identical schedule (bit-exact with
    the kernel path, under noise too, where both share the epilogue and
    the draws, and for sharded plans, which the oracle runs serially)."""
    from repro_torch.runtime.program import program_for_plan
    return program_for_plan(plan, device=device).run(
        params, x, key, noise, reference=True)


class CIMInferenceEngine:
    """Thin compatibility wrapper over a compiled `CIMProgram`.

    Construction goes through the program cache of runtime/program.py, so
    two engines over equal (specs, cfg, device) share one plan and one
    program.  New code holds the program itself: `engine.compile()` (or
    `compile_program(specs, cfg)`) returns it."""

    def __init__(self, specs: Sequence[mapping.LayerSpec],
                 cfg: EngineConfig = EngineConfig(),
                 activations: Optional[Sequence[str]] = None,
                 pools: Optional[Sequence[int]] = None, *, device=None):
        from repro_torch.runtime.program import compile_program
        self.cfg = cfg
        self.program = compile_program(specs, cfg, activations=activations,
                                       pools=pools, device=device)

    @property
    def plan(self) -> NetworkPlan:
        """The backing program's NetworkPlan."""
        return self.program.plan

    def compile(self):
        """The backing CIMProgram - the plan-once/serve-many artifact
        (bind weights with .bind(params), serve with .serve /
        .serve_batch)."""
        return self.program

    def init_params(self, source) -> Params:
        """Distribution-aware per-layer parameters (core/cim_layers init)
        from a `torch.Generator` or a `core/prng` key (the JAX package's
        `init_params(key)` bit for bit)."""
        return init_network_params(self.plan, source)

    def __call__(self, params: Params, x: torch.Tensor, key=None,
                 noise: Optional[NoiseConfig] = None) -> torch.Tensor:
        """Exact-shape dispatch of the compiled schedule (legacy per-call
        API; prefer engine.compile() + program.bind(params).serve(x))."""
        _warn_legacy_entry("CIMInferenceEngine.__call__")
        return self.program.run(params, x, key, noise)

    def reference(self, params: Params, x: torch.Tensor, key=None,
                  noise: Optional[NoiseConfig] = None) -> torch.Tensor:
        """The plain digital oracle of the same plan (bit-exact with
        __call__ at every precision, clean or under a common key)."""
        return self.program.run(params, x, key, noise, reference=True)

    def monte_carlo(self, params: Params, x: torch.Tensor, key,
                    n_trials: int,
                    noise: Optional[NoiseConfig] = None) -> torch.Tensor:
        """Seeded noise trials: (n_trials, *engine(params, x).shape).

        Splits `key` into one subkey per trial with the port's threefry
        split (`core/prng.split`, JAX's `jax.random.split`), so trial t
        is the JAX package's trial t bit for bit, and stacks the outputs:
        n_trials dispatches of one program.  Requires a noise-enabled
        plan."""
        if not self.cfg.noise.enabled:
            raise ValueError("monte_carlo requires EngineConfig(noise=...) "
                             "with noise enabled")
        if n_trials < 1:
            raise ValueError(f"n_trials must be >= 1, got {n_trials}")
        keys = prng.split(key, n_trials)
        return torch.stack([self.program.run(params, x, k, noise)
                            for k in keys])

    def perf_report(self, **kw):
        """The IMAGINE macro model's per-layer and aggregate cycle and
        energy projections (perfmodel.schedule_report; not measurements
        of the device), with the backing program's counters under
        "program"."""
        from repro_torch.perfmodel.macro_perf import schedule_report
        return schedule_report(self.plan, program=self.program, **kw)

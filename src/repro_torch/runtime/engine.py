"""Precision-scalable CIM inference runtime (noise off, one device).

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

Numerics: the kernel path is bit-exact with the plain reference path at
every supported precision, and both are bit-exact with the JAX package.
The activation zero-point is folded into the per-channel ABN beta inside
the ADC floor (beta_eff = beta + gamma*g0*zp_dp), exactly what the chip's
signed-to-unsigned conversion + beta block does; under segment-wise
quantization (per-request isolation) the zero-point is per row, and so is
beta_eff.  Every divide of the quant/dequant chain has a tensor on the
operand's device as its divisor: PyTorch's CUDA divide by a Python scalar
multiplies by the reciprocal instead, which is not the same float.

Units: `dp`/`dp_hat` are integer dot-product units, `*_codes` ADC output
codes in [0, 2^r_out), `g0` codes per dp unit at gamma=1, activations in
and out are real-valued float32.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import abn as abn_lib
from repro_torch.core import digital_ref, mapping
from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO
from repro_torch.core.quantization import quantize_act, quantize_weight
from repro_torch.kernels.cim_mbiw import ops as kops
from repro_torch.kernels.cim_mbiw.ref import cim_matmul_ref

Params = List[Dict[str, torch.Tensor]]

# incremented once per plan_network() call (a compiled program is planned
# exactly once; repeated compile_program calls must be cache hits)
PLAN_COUNT = {"n": 0}


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


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """One layer's macro-tile schedule.

    `n_slices` are *uniform* col tiles (mapping.split_even_slices): every
    tile spans `tile_n` channels and the covered extent `n_pad` may exceed
    spec.n - execution pads the column arrays and discards the excess."""
    spec: mapping.LayerSpec
    mp: mapping.MacroMapping
    precision: kops.KernelPrecision
    g0: float                            # unity-gain codes per dp unit
    k_slices: Tuple[Tuple[int, int], ...]  # (start, size) row tiles
    n_slices: Tuple[Tuple[int, int], ...]  # (start, size) uniform col tiles
    activation: str = "none"             # "none" | "relu"
    pool: int = 1                        # max-pool window/stride epilogue

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
        """Schedule-wide macro invocations per M-row batch of work (with
        stream_rows=0 this is the kernel launch count of one forward)."""
        return sum(lp.macro_evals for lp in self.layers)


def _layer_g0(spec: mapping.LayerSpec, mp: mapping.MacroMapping,
              cfg: EngineConfig) -> float:
    macro = cfg.macro
    units = mp.units_per_tile if cfg.adaptive_swing else macro.n_units
    n_dp = units * macro.rows_per_unit
    return digital_ref.adc_gain_factor(
        spec.r_in, spec.r_w, spec.r_out, n_dp,
        macro.swing_efficiency(units), macro.alpha_adc())


def plan_layer(spec: mapping.LayerSpec, cfg: EngineConfig = EngineConfig(),
               activation: str = "none", pool: int = 1) -> LayerPlan:
    """Plan one layer: macro mapping, uniform col tiles, epilogues.

    Args:
      spec: the GEMM/conv layer.
      cfg: shared execution config.
      activation: "none" | "relu" epilogue.
      pool: max-pool window/stride (conv layers only, 1 = none).
    Returns:
      LayerPlan (hashable; part of the NetworkPlan).
    """
    if pool < 1:
        raise ValueError(f"pool must be >= 1, got {pool}")
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
    prec = kops.KernelPrecision(spec.r_in, spec.r_w, spec.r_out)
    return LayerPlan(
        spec=spec, mp=mp, precision=prec, g0=_layer_g0(spec, mp, cfg),
        k_slices=tuple(mapping.split_k_slices(spec.k, mp.row_tiles)),
        n_slices=tuple(mapping.split_even_slices(spec.n, mp.col_tiles)),
        activation=activation, pool=pool)


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
                 pools: Optional[Sequence[int]] = None) -> NetworkPlan:
    """Plan a feed-forward network of dense and conv-tagged LayerSpecs.

    `activations`: per-layer epilogue nonlinearity; defaults to relu between
    layers and none after the last.  `pools`: per-layer max-pool
    window/stride (1 = none, conv layers only), applied after the
    activation - with the automatic conv -> dense flatten this covers the
    paper's LeNet-class CNNs.
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
    layers = tuple(plan_layer(s, cfg, act, pool)
                   for s, act, pool in zip(specs, activations, pools))
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
      gain/offset (gamma pads with 1.0 - it divides in the dequant).
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
    }


def bind_network(plan: NetworkPlan, params: Params,
                 device: Optional[torch.device] = None
                 ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """bind_layer over a whole plan, run on the host; the products then
    move to `device` (default: stay on the host), so every device serves
    with the identical weight codes and gamma bits.  Validates the
    per-layer param count."""
    if len(params) != len(plan.layers):
        raise ValueError(f"{len(params)} param dicts for "
                         f"{len(plan.layers)} planned layers")
    binds = []
    for lp, p in zip(plan.layers, params):
        host = {k: torch.as_tensor(v).detach().to("cpu", torch.float32)
                for k, v in p.items()}
        b = bind_layer(lp, host, plan.cfg)
        binds.append({k: v.to(device) if device is not None else v
                      for k, v in b.items()})
    return tuple(binds)


def _mask_pad_rows(x: torch.Tensor, m_valid: int) -> torch.Tensor:
    """Overwrite batch rows at index >= m_valid with a copy of row 0.

    Batch-bucketed dispatch pads the leading batch axis up to a bucket
    size; this runs before every layer so the padded rows are always
    duplicates of a live row when the dynamic activation quantization
    computes its global min/max (duplicates never move a min/max), keeping
    the valid rows bit-exact with an unpadded run."""
    idx = torch.arange(x.shape[0], device=x.device).reshape(
        (-1,) + (1,) * (x.dim() - 1))
    return torch.where(idx < m_valid, x, x[:1])


def _tile_schedule(lp: LayerPlan, q_rows: torch.Tensor, zp: torch.Tensor,
                   wqq: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, *, matmul) -> torch.Tensor:
    """One block of GEMM rows through the (k, n) tile schedule.

    `matmul` evaluates one macro tile (kernel variant or plain oracle) and
    returns int32 ADC codes.  `zp` is the activation zero-point in code
    units: a scalar, or per row (rows, 1) under segment-wise quantization,
    which makes the folded ADC offset beta_eff per GEMM row (rows, n).
    Returns dp_hat (rows, n_pad) in dp units."""
    mid = 2.0 ** (lp.spec.r_out - 1)
    g0 = lp.g0
    tsz = lp.tile_n
    gain = gamma * torch.tensor(g0, dtype=torch.float32, device=gamma.device)
    dp_hat = []
    for ni in range(wqq.shape[1] // tsz):
        ns, ne = ni * tsz, (ni + 1) * tsz
        acc = torch.zeros((q_rows.shape[0], tsz), dtype=torch.float32,
                          device=q_rows.device)
        for ks, ksz in lp.k_slices:
            ke = ks + ksz
            # zero-point: x = q*s + z -> z*colsum is per-channel constant,
            # folded into the ABN offset inside the ADC floor
            zp_dp = zp * torch.sum(wqq[ks:ke, ns:ne], dim=0)
            beta_eff = beta[ns:ne] + gain[ns:ne] * zp_dp
            codes = matmul(q_rows[:, ks:ke], wqq[ks:ke, ns:ne],
                           gamma[ns:ne], beta_eff, g0)
            # digital partial-sum recombination in dp units; dequantizing
            # against the *raw* beta keeps the zero-point contribution in
            # dp_hat (the divisor `gain` is a device tensor)
            acc = acc + (codes.to(torch.float32) + 0.5 - mid
                         - beta[None, ns:ne]) / gain[None, ns:ne]
        dp_hat.append(acc)
    return torch.cat(dp_hat, dim=-1)


def _schedule_rows(lp: LayerPlan, cfg: EngineConfig, q_rows: torch.Tensor,
                   zp: torch.Tensor, wqq: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, *, matmul) -> torch.Tensor:
    """Stream `q_rows` through the tile schedule in cfg.stream_rows chunks
    (the im2col streaming stage).  Quantization stays global (or
    per-segment - `zp` is then per-row (M, 1) and chunks alongside the
    rows), so chunking is bit-invariant."""
    m = q_rows.shape[0]
    chunk = cfg.stream_rows if cfg.stream_rows > 0 else max(m, 1)
    parts = [_tile_schedule(lp, q_rows[s:s + chunk],
                            zp if zp.dim() == 0 else zp[s:s + chunk],
                            wqq, gamma, beta, matmul=matmul)
             for s in range(0, max(m, 1), chunk)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, 0)


def _layer_tiles(lp: LayerPlan, bind: Dict[str, torch.Tensor],
                 x2: torch.Tensor, cfg: EngineConfig, *, matmul,
                 seg_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run one layer's tile schedule over (M, K) GEMM rows: activation
    quantization, the tile schedule, dequant and activation.

    `seg_rows` (optional, (M,) int) switches the activation quantization
    to per-segment statistics: the zero-point becomes per-row and folds
    into a per-row beta_eff inside the ADC floor, so rows of different
    segments never share swing state."""
    if seg_rows is None:
        aq = quantize_act(x2, lp.spec.r_in)
    else:
        aq = quantize_act(x2, lp.spec.r_in, segment_ids=seg_rows,
                          num_segments=x2.shape[0])
    zp = aq.zero / aq.scale
    dp_hat = _schedule_rows(lp, cfg, aq.q, zp, bind["wqq"], bind["gamma_p"],
                            bind["beta_p"], matmul=matmul)
    y = dp_hat[:, :lp.spec.n] * aq.scale * bind["w_scale"]
    if lp.activation == "relu":
        y = torch.relu(y)
    elif lp.activation != "none":
        raise ValueError(f"unknown activation {lp.activation!r}")
    return y


def _run_layer(lp: LayerPlan, bind: Dict[str, torch.Tensor],
               x: torch.Tensor, cfg: EngineConfig, *, matmul,
               seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One planned layer end-to-end: im2col (conv), tile schedule,
    activation, pooling, and the reshape back to the next layer's view.

    `seg` holds per *batch sample* (B,) segment ids; a conv layer's im2col
    expansion repeats them across the sample's out_h*out_w GEMM rows, a
    dense layer uses them as they are."""
    g = lp.spec.conv
    if g is not None:
        if x.dim() != 4 or tuple(x.shape[1:]) != g.spatial_in:
            raise ValueError(
                f"conv layer expects (B, {g.h}, {g.w}, {g.c_in}) "
                f"activations, got {tuple(x.shape)}")
        b = x.shape[0]
        rep = g.out_h * g.out_w
        x2 = im2col_patches(x, g).reshape(b * rep, lp.spec.k)
        seg_rows = None if seg is None else torch.repeat_interleave(seg, rep)
    else:
        x2 = x.reshape(x.shape[0], -1)        # conv -> dense flatten (NHWC)
        if x2.shape[-1] != lp.spec.k:
            raise ValueError(f"dense layer expects {lp.spec.k} features, "
                             f"got {x2.shape[-1]} from {tuple(x.shape)}")
        seg_rows = seg
    y = _layer_tiles(lp, bind, x2, cfg, matmul=matmul, seg_rows=seg_rows)
    if g is not None:
        y = y.reshape(b, g.out_h, g.out_w, g.c_out)
    if lp.pool > 1:
        p = lp.pool
        oh, ow = g.out_h // p, g.out_w // p
        y = y[:, :oh * p, :ow * p].reshape(b, oh, p, ow, p, g.c_out)
        y = torch.amax(y, dim=(2, 4))
    return y


def _kernel_matmul(lp: LayerPlan, cfg: EngineConfig):
    def matmul(xq, wqt, gamma_t, beta_t, g0):
        fn = kops.kernel_variant_for_tile(
            lp.precision, xq.shape[0], xq.shape[1], wqt.shape[1],
            bm=cfg.bm, bn=cfg.bn, bk=cfg.bk)
        return fn(xq, wqt, gamma_t, beta_t, g0)
    return matmul


def _reference_matmul(lp: LayerPlan, cfg: EngineConfig):
    def matmul(xq, wqt, gamma_t, beta_t, g0):
        # the plain oracle keeps the ADC floor expression in float-op
        # lockstep with the kernel epilogue (bit-exactness contract)
        return cim_matmul_ref(xq, wqt, gamma_t, beta_t, g0=g0,
                              r_out=lp.spec.r_out)
    return matmul


def _forward(plan: NetworkPlan, binds: Sequence[Dict[str, torch.Tensor]],
             x: torch.Tensor, reference: bool,
             m_valid: Optional[int] = None,
             seg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole schedule over a canonical batch: (B, H, W, C) images for a
    conv-first plan, (B, K0) rows for a dense-first one.  `m_valid` marks
    the live rows of a bucket-padded batch (pad rows are re-pinned to
    copies of row 0 before every layer).  `seg` ((B,) int, optional) are
    the per-sample segment ids of segment-wise activation quantization."""
    xc = x.to(torch.float32)
    if seg is not None and seg.shape[0] != xc.shape[0]:
        raise ValueError(f"segments extent {seg.shape[0]} != canonical "
                         f"batch extent {xc.shape[0]}")
    mk = _reference_matmul if reference else _kernel_matmul
    for lp, bind in zip(plan.layers, binds):
        if m_valid is not None:
            xc = _mask_pad_rows(xc, m_valid)
        xc = _run_layer(lp, bind, xc, plan.cfg, matmul=mk(lp, plan.cfg),
                        seg=seg)
    return xc


def init_network_params(plan: NetworkPlan,
                        generator: torch.Generator) -> Params:
    """Distribution-aware per-layer parameters for a planned network
    (core/cim_layers init, one {"w", "abn_log_gamma", "abn_beta"} dict per
    layer in plan order), drawn on the host from `generator`."""
    from repro_torch.core.cim_layers import CIMConfig, init_cim_linear
    cfg = plan.cfg
    params = []
    for lp in plan.layers:
        lcfg = CIMConfig(
            r_in=lp.spec.r_in, r_w=lp.spec.r_w, r_out=lp.spec.r_out,
            adaptive_swing=cfg.adaptive_swing,
            gamma_bits=cfg.gamma_bits, max_gamma=cfg.max_gamma,
            macro=cfg.macro)
        params.append(init_cim_linear(generator, lp.spec.k, lp.spec.n,
                                      cfg=lcfg))
    return params

"""CIM-quantized layers: the paper's technique as a composable module.

Counterpart of `repro/core/cim_layers.py`: the per-layer `CIMConfig`, the
distribution-aware initialisation, the unity-gain code gain, and
`cim_linear_apply`, the entry every projection of the LM path goes
through, in four of its modes:

  * "bypass"    : plain matmul in the input's dtype (the non-CIM baseline);
  * "fakequant" : the CIM-aware training path.  Exact digital-equivalent
                  integer math (odd-integer weights, unsigned activations,
                  the ABN-scaled floor ADC per <= 1152-row tile) with the
                  JAX package's STE gradients, and with cfg.noise enabled
                  and a PRNG key the post-silicon noise model (calibrated
                  SA-offset residues inside the ADC floor, thermal noise on
                  the dp); its forward equals JAX's bit for bit.
  * "engine"    : the deployed inference path.  The layer is planned into
                  macro tiles at its batch bucket (`runtime/program.py`'s
                  program cache: planned once per shape and config) and
                  served through the cim_mbiw kernels by the one
                  `BoundProgram` of its weights (`program.bound_for`):
                  the weights are quantized once, and on the card each
                  dispatch key replays a captured CUDA graph.  Bit-exact
                  with fakequant without noise.
  * "sim"       : the voltage-domain behavioural macro
                  (`core/cim_macro.py`), tiled per `core/mapping.py`; its
                  noise draws run through the draw kernel's wrapper.
                  Inference only: no gradient flows.
  * "deploy"    : int8 weight codes times a per-channel scale
                  (`quantize_params_for_serving`), a plain product.

`cim_conv2d_apply` runs a conv through the same modes: engine mode plans
the conv natively (the runtime streams the im2col itself), every other
mode materializes the patch tensor and detours through
`cim_linear_apply`.  An engine layer with `CIMConfig.sharding` (a
runtime `ShardingConfig`) runs the sharded multi-macro schedule, bit for
bit equal to the unsharded one.

Parameters per layer: {"w": (K, N) fp32 master weights,
                       "abn_log_gamma": (N,), "abn_beta": (N,)}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Iterator, Optional, Union

import torch

from repro_torch.core import abn as abn_lib
from repro_torch.core import cim_macro, digital_ref, mapping
from repro_torch.core import noise_model as nm
from repro_torch.core import prng
from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO
from repro_torch.core.noise_model import NO_NOISE, NoiseConfig
from repro_torch.core.quantization import (_static_reciprocal, adc_quantize,
                                           quantize_act, quantize_weight,
                                           rounding_barrier)


@dataclasses.dataclass(frozen=True)
class CIMConfig:
    """Per-layer CIM execution configuration."""
    mode: str = "fakequant"          # bypass | fakequant | sim | engine
                                     # | deploy
    r_in: int = 8
    r_w: int = 4
    r_out: int = 8
    adaptive_swing: bool = True      # serial-split DPL swing adaptation
    gamma_bits: int = -1             # -1: continuous gamma; >=0: HW quant
    max_gamma: float = 32.0          # resistive-ladder limit
    noise: NoiseConfig = NO_NOISE    # fakequant: injected under a key;
                                     # engine programs: their noise mode
    macro: CIMMacroConfig = DEFAULT_MACRO
    sharding: Optional[object] = None   # runtime.engine.ShardingConfig -
                                        # multi-macro dispatch in mode
                                        # "engine" (ignored by other modes)
    isolate_rows: bool = False          # mode "engine" only: each leading
                                        # batch row is its own activation-
                                        # quantization segment, so fused
                                        # rows are bit-identical to solo
                                        # rows

    def replace(self, **kw) -> "CIMConfig":
        """A copy of this config with the given fields replaced."""
        return dataclasses.replace(self, **kw)


def analytic_log_gamma_init(k: int, cfg: CIMConfig,
                            target_frac: float = 0.25) -> float:
    """Distribution-aware gamma init (no calibration data needed): scale the
    expected DP std of one macro row-tile to `target_frac` of the ADC
    half-range.  Assumes amax-scaled ~N activations/weights, for which the
    integer codes have std ~2^r_in/8 and ~2^(r_w-1)/2."""
    k_tile = -(-k // (-(-k // cfg.macro.n_rows)))   # rows per even row tile
    g0 = _code_gain(cfg, k)
    sigma_dp = (k_tile ** 0.5) * (2.0 ** cfg.r_in / 8.0) \
        * (2.0 ** (cfg.r_w - 1) / 2.0)
    gamma = target_frac * 2.0 ** (cfg.r_out - 1) / (g0 * sigma_dp)
    gamma = min(max(gamma, 1.0), float(cfg.max_gamma))
    return math.log2(gamma)


def init_cim_linear(source: Union[torch.Generator, torch.Tensor], k: int,
                    n: int, w_init_scale: Optional[float] = None,
                    cfg: Optional[CIMConfig] = None) -> Dict:
    """Init one CIM linear: fan-in-scaled weights plus the per-output-
    column ABN gain/offset (gamma seeded analytically when `cfg` is
    given, else unity).

    `source` is a `torch.Generator`, whose device the weights are drawn
    on, or a `core/prng` key ((2,) int64), which draws the JAX package's
    weights bit for bit (`scale * jax.random.normal(key, (k, n))` in
    float32) on the key's device."""
    scale = w_init_scale if w_init_scale is not None else (1.0 / k) ** 0.5
    lg = 0.0 if cfg is None else analytic_log_gamma_init(k, cfg)
    if isinstance(source, torch.Generator):
        dev = source.device
        w = torch.randn((k, n), generator=source, dtype=torch.float32,
                        device=dev)
    else:
        w = prng.normal(source, (k, n))
        dev = w.device
    return {
        "w": scale * w,
        "abn_log_gamma": torch.full((n,), lg, dtype=torch.float32,
                                    device=dev),
        "abn_beta": torch.zeros((n,), dtype=torch.float32, device=dev),
    }


def _code_gain(cfg: CIMConfig, k_dim: int) -> float:
    """Unity-gain codes-per-integer-dp (Eq. 7 collapsed, digital_ref).

    K > n_rows splits into the even row tiles of mapping.map_layer, so the
    swing (and hence g0) follows rows-per-tile - in lockstep with the
    runtime engine's per-tile ADC configuration."""
    macro = cfg.macro
    if cfg.adaptive_swing:
        row_tiles = -(-k_dim // macro.n_rows)
        rows = -(-k_dim // row_tiles)
        units = macro.units_for_rows(rows)
    else:
        units = macro.n_units          # fixed full-array swing (baseline)
    n_dp = units * macro.rows_per_unit
    swing = macro.swing_efficiency(units)
    return digital_ref.adc_gain_factor(cfg.r_in, cfg.r_w, cfg.r_out, n_dp,
                                       swing, macro.alpha_adc())


def _engine_config(cfg: CIMConfig):
    """The runtime EngineConfig mirroring a layer-level CIMConfig (so equal
    layer configs hit one program-cache entry)."""
    from repro_torch.runtime import engine as rt
    if cfg.sharding is not None \
            and not isinstance(cfg.sharding, rt.ShardingConfig):
        raise TypeError(f"CIMConfig.sharding must be a runtime "
                        f"ShardingConfig, got {type(cfg.sharding).__name__}")
    return rt.EngineConfig(macro=cfg.macro, adaptive_swing=cfg.adaptive_swing,
                           gamma_bits=cfg.gamma_bits, max_gamma=cfg.max_gamma,
                           noise=cfg.noise, sharding=cfg.sharding)


def _engine_forward(params: Dict, x: torch.Tensor, cfg: CIMConfig,
                    key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's `_engine_forward`: the layer through the
    inference runtime.

    The rows of x collapse to one batch axis, which selects the batch
    bucket; the program of (bucket, K, N, precision, config) comes from
    the program cache on x's device (planned once per shape and config),
    and the one BoundProgram of these weights serves it
    (`program.bound_for`: bound on first sight, re-bound only when a
    weight tensor is replaced or changed in place).  With
    cfg.isolate_rows each leading batch row is its own activation-
    quantization segment.  The result is cast to x's dtype.  Inference
    only: no gradient flows."""
    from repro_torch.runtime.program import (DEFAULT_BUCKETS, bound_for,
                                             compile_program)
    k_dim, n = params["w"].shape
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, k_dim)
    bucket = DEFAULT_BUCKETS.bucket_for(x2.shape[0])
    spec = mapping.LayerSpec(m=bucket, k=k_dim, n=n, r_in=cfg.r_in,
                             r_w=cfg.r_w, r_out=cfg.r_out)
    prog = compile_program([spec], _engine_config(cfg), device=x.device)
    segments = None
    if cfg.isolate_rows and lead:
        # one segment per leading batch row: (B, S, K) -> B segments of S
        # rows each, so fused rows quantize exactly as served alone
        rows = x2.shape[0] // lead[0]
        segments = torch.arange(lead[0], device=x.device)[:, None].expand(
            lead[0], rows).reshape(-1)
    y = bound_for(prog, params).serve(x2, key, segments=segments)
    return y.reshape(lead + (n,)).to(x.dtype)


def cim_linear_apply(params: Dict, x: torch.Tensor, cfg: CIMConfig,
                     key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y ~= x @ w, executed through the configured CIM path.

    x: (..., K).  Returns (..., N) in x's dtype.  `key` (a host
    `core/prng` key) seeds the noise model when cfg.noise is enabled;
    without one fakequant runs clean, as the JAX package's does, and an
    engine layer planned with noise raises.  An engine layer runs on x's
    device."""
    if cfg.mode == "deploy":
        # serving weights: int8 CIM codes times a per-channel scale
        wq = params["w_q"].to(x.dtype) * params["w_scale"].to(x.dtype)
        return x @ wq
    w = params["w"]
    if cfg.mode == "bypass":
        return x @ w.to(x.dtype)
    if cfg.mode == "fakequant":
        return _fakequant_forward(params, x, cfg, key)
    if cfg.mode == "engine":
        return _engine_forward(params, x, cfg, key)
    if cfg.mode == "sim":
        return _sim_forward(params, x, cfg, key)
    raise ValueError(f"unknown CIM mode {cfg.mode!r}")


def quantize_params_for_serving(params, r_w: int = 4):
    """Every CIM-linear leaf dict {w, abn_*} of a parameter tree (dicts and
    lists) in its deployed form {w_q int8, w_scale f32 (N,), abn_*}: the
    macro's odd-integer weight grid in its natural int8 container.
    Embeddings and norms stay as they are.  Works on stacked (..., K, N)
    leaves too (scales over the reduction axis).  An MoE block (a dict
    with "router") gets its expert banks w_gate / w_up / w_down as
    `{name}_q` int8 and `{name}_scale`, per (expert, channel) over axis
    -2; its router and ABN stay."""
    def convert(node):
        if isinstance(node, dict) and "router" in node:
            out = dict(node)
            for k in ("w_gate", "w_up", "w_down"):
                if k in out:
                    wq = quantize_weight(out.pop(k), r_w, axis=-2)
                    out[f"{k}_q"] = wq.q.to(torch.int8)
                    out[f"{k}_scale"] = torch.squeeze(wq.scale, dim=-2)
            return out
        if isinstance(node, dict) and "w" in node and "abn_log_gamma" in node:
            wq = quantize_weight(node["w"], r_w, axis=-2)
            out = {k: v for k, v in node.items() if k != "w"}
            out["w_q"] = wq.q.to(torch.int8)
            out["w_scale"] = torch.squeeze(wq.scale, dim=-2)
            return out
        if isinstance(node, dict):
            return {k: convert(v) for k, v in node.items()}
        if isinstance(node, list):
            return [convert(v) for v in node]
        return node

    with torch.no_grad():
        return convert(params)


@contextlib.contextmanager
def exact_float32_matmul() -> Iterator[None]:
    """Float32 matmuls in full float32 (no TF32) inside the block, and the
    caller's matmul precision as it was afterwards, whichever API set it.

    Fakequant's integer products must come out exact (|dp| <= 1152 * 255
    * 15 < 2^24); TF32 rounds each operand to 10 mantissa bits, which
    today's 8-bit codes and 4-bit weights survive, but the exactness
    should rest on neither that nor a process-wide flag.  The pin goes
    through the legacy `set_float32_matmul_precision("highest")`, which
    keeps the legacy and the per-backend settings
    (`torch.backends.cuda.matmul.fp32_precision`, where this PyTorch has
    it) in agreement, so that no reader of either raises inside the
    block; both are put back as they were."""
    mm = torch.backends.cuda.matmul
    prev_backend = getattr(mm, "fp32_precision", None)
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:      # set through the per-backend API only
        prev = None
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if prev is not None:
            torch.set_float32_matmul_precision(prev)
        if prev_backend is not None:
            mm.fp32_precision = prev_backend


def _fakequant_forward(params: Dict, x: torch.Tensor, cfg: CIMConfig,
                       key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's `_fakequant_forward`, op for op.

    Under noise (cfg.noise enabled and a key) the key splits once for the
    SA-offset residues (sampled per physical column, gathered per
    channel, added to beta inside the ADC floor) and once per row tile
    for that tile's thermal field of dp's shape.  The residues are one
    launch of the draw kernel and each row tile's field another, dropped
    before the next tile's (the residues' 256 normals drawn at a field's
    length, to share its launch, would add a field's worth of draws).
    The noise config's fields are Python floats here, so its scalars
    fold in double, as in JAX with the config static."""
    w = params["w"]
    k_dim, n = w.shape
    x32 = rounding_barrier(x.to(torch.float32))

    aq = quantize_act(x32, cfg.r_in)
    wq = quantize_weight(w, cfg.r_w, axis=0)

    gamma = abn_lib.abn_gamma(
        abn_lib.ABNParams(params["abn_log_gamma"], params["abn_beta"]),
        gamma_bits=cfg.gamma_bits, max_gamma=cfg.max_gamma)
    g0 = _code_gain(cfg, k_dim)
    mid = 2.0 ** (cfg.r_out - 1)
    noisy = cfg.noise.enabled and key is not None
    out_shape = x32.shape[:-1] + (n,)
    numel = 1
    for d in out_shape:
        numel *= d

    # K > n_rows splits into even row tiles, each with its own ADC
    # conversion; partial codes are dequantized and summed digitally
    row_tiles = -(-k_dim // cfg.macro.n_rows)
    slices = mapping.split_k_slices(k_dim, row_tiles)
    offset_codes = 0.0
    tile_keys = []
    if noisy:
        from repro_torch.kernels.prng.kernel import threefry_normal
        # JAX: key, k2 = split(key); then key, k1 = split(key) per tile
        k = prng.key_ints(key)
        k, k2 = prng.threefry2x32(*k, 0, 0), prng.threefry2x32(*k, 0, 1)
        for _ in slices:
            k, k1 = prng.threefry2x32(*k, 0, 0), prng.threefry2x32(*k, 0, 1)
            tile_keys.append(k1)
        z = threefry_normal(torch.tensor([k2], dtype=torch.int64,
                                         device=x.device), cfg.macro.n_cols)
        # residual SA offset in code units, static per layer call
        res_v = nm.column_residues_from_offsets(
            nm.sa_offsets_from_normal(z[0], cfg.noise), n, cfg.r_w,
            cfg.noise, cfg.macro)
        lsb_v = cfg.macro.alpha_adc() * cfg.macro.vddh \
            / 2.0 ** (cfg.r_out - 1)
        offset_codes = rounding_barrier(gamma * res_v
                                        * _static_reciprocal(lsb_v))
        sigma_dp = nm.thermal_sigma_dp(cfg.noise, cfg.r_out, g0)
    gain = rounding_barrier(gamma * g0)
    zp = aq.zero / aq.scale
    dp_hat = torch.zeros(out_shape, dtype=torch.float32, device=x.device)
    for t, (ks, ksz) in enumerate(slices):
        ke = ks + ksz
        # integer dot product, exact in fp32 for one macro row tile
        # (|dp| <= 1152*255*15 < 2^24) as long as TF32 stays off, whatever
        # the caller set; the backward's products keep the caller's
        # precision (they are not exact in the reference either)
        with exact_float32_matmul():
            dp = aq.q[..., ks:ke] @ wq.q[ks:ke, :]
        # zero-point x = q*s + z: the z*colsum term folds into the ABN
        # offset inside the ADC floor (beta_eff = beta + gamma*g0*zp_dp)
        zp_dp = zp * torch.sum(wq.q[ks:ke, :], dim=0)
        if noisy:
            field = threefry_normal(
                torch.tensor([tile_keys[t]], dtype=torch.int64,
                             device=x.device), numel).reshape(out_shape)
            # thermal noise referred to dp units through the code gain
            dp = dp + sigma_dp * field
            field = None
        beta_eff = (params["abn_beta"] + offset_codes) \
            + rounding_barrier(gain * zp_dp)
        code = adc_quantize(dp, r_out=cfg.r_out, gain=gain,
                            beta_codes=beta_eff)
        dp_hat = dp_hat + (code - mid - params["abn_beta"]) / gain

    y = rounding_barrier(dp_hat * aq.scale * wq.scale.reshape(-1))
    return y.to(x.dtype)


@torch.no_grad()
def _sim_forward(params: Dict, x: torch.Tensor, cfg: CIMConfig,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's `_sim_forward`: tile per mapping.py and run the
    behavioural macro on x's device.  No gradients (inference/fidelity
    only).  Under noise (cfg.noise enabled and a key) the key splits once
    for the SA-offset residues, shared by every row tile (the comparators
    do not change between tiles), and once per row tile for that tile's
    macro draws."""
    w = params["w"]
    k_dim, n = w.shape
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, k_dim).to(torch.float32)

    aq = quantize_act(x2, cfg.r_in)
    wq = quantize_weight(w, cfg.r_w, axis=0)
    planes_full = digital_ref.encode_weight_planes(
        wq.q.to(torch.int32), cfg.r_w)                    # (r_w, K, N)

    gamma = abn_lib.abn_gamma(
        abn_lib.ABNParams(params["abn_log_gamma"], params["abn_beta"]),
        gamma_bits=cfg.gamma_bits, max_gamma=cfg.max_gamma)
    spec = mapping.LayerSpec(m=x2.shape[0], k=k_dim, n=n, r_in=cfg.r_in,
                             r_w=cfg.r_w, r_out=cfg.r_out)
    mp = mapping.map_layer(spec, cfg.macro)
    mid = 2.0 ** (cfg.r_out - 1)
    lsb_v = cfg.macro.alpha_adc() * cfg.macro.vddh / 2.0 ** (cfg.r_out - 1)
    beta_v = params["abn_beta"] * lsb_v / gamma           # code -> volts

    if cfg.noise.enabled and key is not None:
        key, ksa = prng.split(key)
        sa_offset_v = nm.sample_column_residues(ksa, n, cfg.r_w, cfg.noise,
                                                cfg.macro, device=x.device)
    else:
        sa_offset_v = torch.zeros((n,), dtype=torch.float32,
                                  device=x.device)

    dp_hat = torch.zeros((x2.shape[0], n), dtype=torch.float32,
                         device=x.device)
    for ks, ksz in mapping.split_k_slices(k_dim, mp.row_tiles):
        sub = None
        if key is not None:
            key, sub = prng.split(key)
        code = cim_macro.cim_macro_forward(
            aq.q[:, ks:ks + ksz], planes_full[:, ks:ks + ksz, :],
            r_in=cfg.r_in, r_out=cfg.r_out, gamma=gamma, beta_v=beta_v,
            cfg=cfg.macro, noise=cfg.noise, key=sub,
            sa_offset_v=sa_offset_v)
        units = cfg.macro.units_for_rows(ksz)
        n_dp = units * cfg.macro.rows_per_unit
        g0 = digital_ref.adc_gain_factor(
            cfg.r_in, cfg.r_w, cfg.r_out, n_dp,
            cfg.macro.swing_efficiency(units), cfg.macro.alpha_adc())
        dp_hat = dp_hat + (code.to(torch.float32) + 0.5 - mid
                           - params["abn_beta"]) / (gamma * g0)
    y = dp_hat * aq.scale * wq.scale.reshape(-1)
    y = y + aq.zero * torch.sum(wq.q * wq.scale, dim=0)   # zero-point term
    return y.reshape(lead + (n,)).to(x.dtype)


def cim_conv2d_apply(params: Dict, x: torch.Tensor, cfg: CIMConfig,
                     stride: int = 1, padding=1,
                     key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Conv2D through the CIM stack (the accelerator's stage (ii)).

    x: (B, H, W, C_in) (NHWC); params["w"]: (kh*kw*C_in, C_out) flattened
    filters in (kh, kw, c) order.  `padding` accepts an int, "SAME"/
    "VALID", or explicit per-edge pairs (mapping.resolve_padding).
    mode="engine" plans the conv natively (the runtime performs the im2col
    streaming itself); every other mode materializes the patch tensor
    (`runtime.engine.im2col_patches`, slicing and stacking, so
    differentiable) and detours through cim_linear_apply."""
    from repro_torch.runtime.engine import im2col_patches

    k_flat, c_out = params["w"].shape
    kh = kw = int(round((k_flat // x.shape[-1]) ** 0.5))
    if kh * kw * x.shape[-1] != k_flat:
        raise ValueError(f"weights of {k_flat} rows are not a square "
                         f"filter over {x.shape[-1]} input channels")
    b, h, w, c_in = x.shape
    spec = mapping.conv_layer_spec(
        batch=b, h=h, w=w, c_in=c_in, c_out=c_out, kh=kh, kw=kw,
        stride=stride, padding=padding,
        r_in=cfg.r_in, r_w=cfg.r_w, r_out=cfg.r_out)
    if cfg.mode == "engine":
        return _engine_conv_forward(params, x, cfg, spec, key)
    patches = im2col_patches(x, spec.conv)        # (B, OH, OW, kh*kw*C)
    return cim_linear_apply(params, patches, cfg, key)


def _engine_conv_forward(params: Dict, x: torch.Tensor, cfg: CIMConfig,
                         spec: mapping.LayerSpec,
                         key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX package's `_engine_conv_forward`: the conv spec rebuilt at
    the batch bucket, its program from the program cache on x's device
    (planned once per geometry and config) and the one BoundProgram of
    these weights (`program.bound_for`), so a clean dispatch on the card
    replays its CUDA graph.  With cfg.isolate_rows each image is its own
    activation-quantization segment.  Inference only."""
    from repro_torch.runtime.program import (DEFAULT_BUCKETS, bound_for,
                                             compile_program)
    g = spec.conv
    bucket = DEFAULT_BUCKETS.bucket_for(x.shape[0])
    if bucket != g.batch:
        spec = mapping.conv_layer_spec(
            batch=bucket, h=g.h, w=g.w, c_in=g.c_in, c_out=g.c_out,
            kh=g.kh, kw=g.kw, stride=g.stride, padding=g.padding,
            r_in=spec.r_in, r_w=spec.r_w, r_out=spec.r_out)
    prog = compile_program([spec], _engine_config(cfg), device=x.device)
    segments = None
    if cfg.isolate_rows:
        # one segment per batch image (the engine repeats ids over the
        # conv's out_h*out_w GEMM rows itself)
        segments = torch.arange(x.shape[0], device=x.device)
    return bound_for(prog, params).serve(x, key, segments=segments).to(
        x.dtype)

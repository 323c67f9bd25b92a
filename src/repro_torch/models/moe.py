"""Mixture-of-experts FFN: top-k routing into fixed-capacity expert groups.

Counterpart of `repro/models/moe.py`.  Tokens are routed top-k (a stable
descending sort, so ties go to the lower expert index as
`jax.lax.top_k` puts them), sorted into a capacity grid per expert
(dropped-token discipline, `capacity_factor`), run through the expert
GEMMs as batched products over the expert axis, and combined back per
token weighted by their gates.

Per-expert ABN: the CIM fakequant path quantizes each expert's weights
with per-(expert, channel) scales and applies per-expert gamma / beta;
every expert sees a different token distribution, which is where the
paper's distribution-aware reshaping argument is strongest.

CIM modes: "fakequant" runs the batched products with per-expert
activation statistics (segment quantization over the expert axis) and
the zero-point folded inside the ADC floor, the arithmetic of
`core.cim_layers._fakequant_forward`; "engine" serves every expert's
capacity group through one compiled CIM program per (capacity bucket,
fan-in, fan-out, precision) shape, bound once per expert
(`program.bound_for` over per-expert views kept for the life of the
bank), so E experts hit one program-cache entry and a decode step after
warm-up makes no bind, capture or plan.  The two are bit for bit equal
without noise.  "bypass" / "deploy" run a plain product; any other mode
raises ValueError, so an engine-mode serving config never falls back to
an unquantized float product.

Under a model-level mesh (`models.sharding.use_mesh`) with a data or
model axis that would split the tokens or the experts' d_ff, the JAX
package runs a shard_map with a psum over "model"; the port raises
NotImplementedError there (ROADMAP Queue 1 left-overs, the shard_map path
of moe_block).  Engine mode, and a mesh whose axes split nothing, run the
local path, as JAX does.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import abn as abn_lib
from repro_torch.core import mapping
from repro_torch.core import noise_model as nm
from repro_torch.core import prng
from repro_torch.core.cim_layers import (CIMConfig, _code_gain,
                                         _engine_config,
                                         exact_float32_matmul)
from repro_torch.core.quantization import (adc_quantize, quantize_act,
                                           quantize_weight, rounding_barrier)
from repro_torch.models.common import activation_fn
from repro_torch.models.sharding import BATCH, TP, get_mesh

Abn = Optional[Tuple[torch.Tensor, torch.Tensor]]


def init_moe(source: Union[torch.Generator, torch.Tensor], d: int, f: int,
             n_experts: int, cim: Optional[CIMConfig] = None) -> Dict:
    """Router + expert bank params: w_gate / w_up (E, D, F), w_down (E, F,
    D), per-expert ABN gamma / beta on the down-projection's D outputs.

    `source` is a `torch.Generator` (drawn on its device in the order
    router, w_gate, w_up, w_down) or a `core/prng` key, which draws the
    JAX package's weights bit for bit (split(key, 4), one normal each)."""
    s_in = (1.0 / d) ** 0.5
    s_out = (1.0 / f) ** 0.5
    shapes = ((d, n_experts), (n_experts, d, f), (n_experts, d, f),
              (n_experts, f, d))
    if isinstance(source, torch.Generator):
        dev = source.device
        z = [torch.randn(s, generator=source, dtype=torch.float32,
                         device=dev) for s in shapes]
    else:
        ks = prng.split(source, 4)
        z = [prng.normal(ks[i], s) for i, s in enumerate(shapes)]
        dev = z[0].device
    return {
        "router": s_in * z[0],
        "w_gate": s_in * z[1],
        "w_up": s_in * z[2],
        "w_down": s_out * z[3],
        "abn_log_gamma": torch.zeros((n_experts, d), dtype=torch.float32,
                                     device=dev),
        "abn_beta": torch.zeros((n_experts, d), dtype=torch.float32,
                                device=dev),
    }


def _get_expert_w(params: Dict, name: str, dtype: torch.dtype
                  ) -> torch.Tensor:
    """The raw bank, or a deploy-quantized one dequantized to `dtype`."""
    if f"{name}_q" in params:
        return (params[f"{name}_q"].to(dtype)
                * params[f"{name}_scale"][..., None, :].to(dtype))
    return params[name]


def _expert_abn(abn: Abn, e: int, f: int, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-expert ABN params, defaulting to log2(gamma) = 4 / beta = 0 for
    the projections that carry no learned reshaping (gate / up)."""
    if abn is not None:
        return abn[0], abn[1]
    return (torch.full((e, f), 4.0, dtype=torch.float32, device=device),
            torch.zeros((e, f), dtype=torch.float32, device=device))


class _BankViews:
    """One bank's per-expert layer dicts {"w", "abn_log_gamma",
    "abn_beta"} for `program.bound_for`, whose cache keys on the tensors'
    identity, made once and kept while the bank lives.

    Each entry is a view of the bank's `detach()`, not of the bank: a view
    keeps its base's Python object alive, and the bank must be free to
    die (its entry leaves with it, and the experts' binds with their
    views), while a detached alias shares the bank's storage and version
    counter, so an in-place update of the bank still re-binds.  The gate
    / up banks' default ABN tensors live here too."""

    __slots__ = ("abn", "experts")

    def __init__(self, w: torch.Tensor, abn: Abn):
        self.abn = abn
        lg, bt = _expert_abn(abn, w.shape[0], w.shape[2], w.device)
        w, lg, bt = w.detach(), lg.detach(), bt.detach()
        self.experts = [{"w": w[ei], "abn_log_gamma": lg[ei],
                         "abn_beta": bt[ei]} for ei in range(w.shape[0])]

    def current(self, abn: Abn) -> bool:
        if abn is None or self.abn is None:
            return abn is None and self.abn is None
        return abn[0] is self.abn[0] and abn[1] is self.abn[1]


# keyed by id() of the bank tensor; an entry leaves with its bank
_BANK_VIEWS: Dict[int, _BankViews] = {}


def _expert_params(w: torch.Tensor, abn: Abn) -> List[Dict]:
    """The per-expert layer dicts of bank `w` (E, K, N) with `abn` (or
    the gate / up defaults), the same objects on every call."""
    wid = id(w)
    entry = _BANK_VIEWS.get(wid)
    if entry is None or not entry.current(abn):
        if entry is None:
            weakref.finalize(w, _BANK_VIEWS.pop, wid, None)
        entry = _BankViews(w, abn)
        _BANK_VIEWS[wid] = entry
    return entry.experts


def _expert_gemm_engine(x_g: torch.Tensor, w: torch.Tensor, cim: CIMConfig,
                        abn: Abn, key: Optional[torch.Tensor],
                        reference: bool) -> torch.Tensor:
    """(E, C, D) x (E, D, F) through ONE compiled CIM program, E binds.

    Every expert shares the LayerSpec (capacity bucket, fan-in, fan-out,
    precision), so compile_program returns one cached program; the
    experts' weights and ABN differ only in the bind (one BoundProgram an
    expert, made once).  Expert ei draws its noise under fold_in(key,
    ei)."""
    from repro_torch.runtime.program import (DEFAULT_BUCKETS, bound_for,
                                             compile_program)
    e, c, d = x_g.shape
    f = w.shape[2]
    # entry / exit barriers, as _expert_gemm's fakequant branch
    x_g = rounding_barrier(x_g)
    spec = mapping.LayerSpec(m=DEFAULT_BUCKETS.bucket_for(c), k=d, n=f,
                             r_in=cim.r_in, r_w=cim.r_w, r_out=cim.r_out)
    prog = compile_program([spec], _engine_config(cim), device=x_g.device)
    if w.dtype != torch.float32:
        w = w.to(torch.float32)
    outs = []
    for ei, p in enumerate(_expert_params(w, abn)):
        sub = None if key is None else prng.fold_in(key, ei)
        outs.append(bound_for(prog, p).serve(
            x_g[ei].to(torch.float32), sub, reference=reference))
    return rounding_barrier(torch.stack(outs)).to(x_g.dtype)


def _expert_gemm(x_g: torch.Tensor, w: torch.Tensor, cim: CIMConfig,
                 abn: Abn = None, *, key: Optional[torch.Tensor] = None,
                 reference: bool = False) -> torch.Tensor:
    """(E, C, D) x (E, D, F) -> (E, C, F) through the configured CIM path.

    fakequant: per-expert activation statistics (segment quantization over
    the expert axis), per-(expert, channel) weight scales, per-expert ABN,
    and the zero-point folded into the ABN offset inside the per-row-tile
    ADC floor, the arithmetic of core.cim_layers._fakequant_forward, so it
    equals mode "engine" bit for bit without noise.  Under noise (cfg.noise
    enabled and a key) split(key) gives k2, whose split(k2, E) draw each
    expert's SA-offset residues, then one split a row tile for that
    tile's thermal field.  engine: per-expert bound programs
    (_expert_gemm_engine).  bypass / deploy: a plain product.  Anything
    else raises ValueError."""
    if cim.mode in ("bypass", "deploy"):
        return torch.bmm(x_g, w.to(x_g.dtype))
    if cim.mode == "engine":
        return _expert_gemm_engine(x_g, w, cim, abn, key, reference)
    if cim.mode != "fakequant":
        raise ValueError(
            f"moe expert GEMM does not support CIM mode {cim.mode!r}; "
            "use fakequant, engine, bypass or deploy")
    e = x_g.shape[0]
    fan_in, fan_out = w.shape[1], w.shape[2]
    dev = x_g.device
    x_g = rounding_barrier(x_g)
    aq = quantize_act(x_g.to(torch.float32), cim.r_in,
                      segment_ids=torch.arange(e, device=dev),
                      num_segments=e)                 # per-expert stats
    wq = quantize_weight(w, cim.r_w, axis=1)          # scale (E, 1, F)
    lg, bt = _expert_abn(abn, e, fan_out, dev)
    gamma = abn_lib.abn_gamma(
        abn_lib.ABNParams(lg, bt), gamma_bits=cim.gamma_bits,
        max_gamma=cim.max_gamma)[:, None, :]          # (E, 1, F)
    beta = bt[:, None, :]
    g0 = _code_gain(cim, fan_in)
    mid = 2.0 ** (cim.r_out - 1)

    row_tiles = -(-fan_in // cim.macro.n_rows)
    slices = mapping.split_k_slices(fan_in, row_tiles)
    noisy = cim.noise.enabled and key is not None
    offset_codes = 0.0
    tile_keys = []
    if noisy:
        from repro_torch.kernels.prng.kernel import threefry_normal
        # JAX: key, k2 = split(key); residues under split(k2, E)[ei];
        # then key, k1 = split(key) per row tile
        k = prng.key_ints(key)
        k, k2 = prng.threefry2x32(*k, 0, 0), prng.threefry2x32(*k, 0, 1)
        for _ in slices:
            k, k1 = prng.threefry2x32(*k, 0, 0), prng.threefry2x32(*k, 0, 1)
            tile_keys.append(k1)
        z = threefry_normal(prng.split(torch.tensor(k2, dtype=torch.int64),
                                       e).to(dev), cim.macro.n_cols)
        res_v = torch.stack([nm.column_residues_from_offsets(
            nm.sa_offsets_from_normal(z[ei], cim.noise), fan_out, cim.r_w,
            cim.noise, cim.macro) for ei in range(e)])     # (E, F)
        lsb_v = cim.macro.alpha_adc() * cim.macro.vddh \
            / 2.0 ** (cim.r_out - 1)
        # a true divide (JAX divides here), by a tensor on x's device, so
        # that no backend turns it into a reciprocal multiply
        offset_codes = (gamma * res_v[:, None, :]) / torch.full(
            (), lsb_v, dtype=torch.float32, device=dev)
        sigma_dp = nm.thermal_sigma_dp(cim.noise, cim.r_out, g0)

    gain = rounding_barrier(gamma * g0)
    zp = aq.zero / aq.scale                           # (E, 1, 1)
    out_shape = tuple(x_g.shape[:-1]) + (fan_out,)
    dp_hat = torch.zeros(out_shape, dtype=torch.float32, device=dev)
    for t, (ks, ksz) in enumerate(slices):
        ke = ks + ksz
        # integer products, exact in float32 for one macro row tile
        with exact_float32_matmul():
            dp = torch.bmm(aq.q[..., ks:ke], wq.q[:, ks:ke, :])
        zp_dp = zp * torch.sum(wq.q[:, ks:ke, :], dim=1, keepdim=True)
        if noisy:
            field = threefry_normal(
                torch.tensor([tile_keys[t]], dtype=torch.int64, device=dev),
                dp.numel()).reshape(out_shape)
            dp = dp + sigma_dp * field
            field = None
        beta_eff = (beta + offset_codes) + gain * zp_dp
        code = adc_quantize(dp, r_out=cim.r_out, gain=gain,
                            beta_codes=beta_eff)
        dp_hat = dp_hat + (code - mid - beta) / gain
    return rounding_barrier(dp_hat * aq.scale * wq.scale).to(x_g.dtype)


def capacity(t: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    """Slots an expert group holds for t tokens: max(8, min(int(cf * k *
    t / E + 0.5), t * k))."""
    cap = int(capacity_factor * top_k * t / n_experts + 0.5)
    return max(8, min(cap, t * top_k))


def capacity_grid(probs: torch.Tensor, top_idx: torch.Tensor, *,
                  n_experts: int, top_k: int, capacity_factor: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tok_grid (E, C) token ids, gate_grid (E, C) gates, keep (t * k,)
    in expert-sorted order) for probs / top_idx (t, k).

    The (token, choice) pairs sort stably by expert; a pair's rank in its
    expert's group is its slot, and a rank >= C overflows into a dropped
    bin.  Empty slots hold token 0 with gate 0."""
    t = top_idx.shape[0]
    dev = top_idx.device
    cap = capacity(t, n_experts, top_k, capacity_factor)
    flat_e = top_idx.reshape(-1).to(torch.int64)
    flat_tok = torch.arange(t, device=dev).repeat_interleave(top_k)
    flat_p = probs.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    same = F.one_hot(e_sorted, n_experts)
    rank = (torch.cumsum(same, dim=0) - 1)[
        torch.arange(t * top_k, device=dev), e_sorted]
    keep = rank < cap
    slot = torch.where(keep, e_sorted * cap + rank,
                       torch.full_like(rank, n_experts * cap))
    # the overflow bin (index E * C) takes every dropped pair, in any
    # order: it is sliced off
    tok_grid = torch.zeros((n_experts * cap + 1,), dtype=torch.int64,
                           device=dev)
    tok_grid[slot] = flat_tok[order]
    gate_grid = torch.zeros((n_experts * cap + 1,), dtype=flat_p.dtype,
                            device=dev)
    gate_grid[slot] = torch.where(keep, flat_p[order],
                                  torch.zeros_like(flat_p))
    return (tok_grid[:-1].reshape(n_experts, cap),
            gate_grid[:-1].reshape(n_experts, cap), keep)


def _moe_local(x: torch.Tensor, probs: torch.Tensor, top_idx: torch.Tensor,
               w_gate: Optional[torch.Tensor], w_up: torch.Tensor,
               w_down: torch.Tensor, abn_lg: torch.Tensor,
               abn_b: torch.Tensor, key: Optional[torch.Tensor] = None, *,
               n_experts: int, top_k: int, capacity_factor: float,
               cim: CIMConfig, act: str, reference: bool = False
               ) -> torch.Tensor:
    """Dropped-token expert execution over all tokens.

    x (t, D); probs / top_idx (t, k).  Returns (t, D).  `key` seeds the
    banks' noise: fold_in(key, 0 / 1 / 2) for the up, gate and down
    banks."""
    t, d = x.shape
    tok_grid, gate_grid, _ = capacity_grid(
        probs, top_idx, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor)
    k_up = k_gate = k_down = None
    if key is not None:
        k_up, k_gate, k_down = (prng.fold_in(key, i) for i in range(3))
    # empty slots gather token 0's row, as JAX's x[tok_grid]: fakequant's
    # per-expert activation statistics see it
    x_g = x[tok_grid]                                  # (E, C, D)
    h_up = _expert_gemm(x_g, w_up, cim, key=k_up, reference=reference)
    fn = activation_fn(act)
    if w_gate is not None:
        h = fn(_expert_gemm(x_g, w_gate, cim, key=k_gate,
                            reference=reference)) * h_up
    else:
        h = fn(h_up)
    y_g = _expert_gemm(h, w_down, cim, abn=(abn_lg, abn_b), key=k_down,
                       reference=reference)            # (E, C, D)
    y_g = y_g * gate_grid[..., None].to(y_g.dtype)
    # JAX's zeros.at[tok].add(y_g): a token gets at most top_k nonzero
    # terms, the empty slots add +-0, so with top_k <= 2 every order of
    # the sum rounds alike and index_add_'s atomics on the card are exact
    # to it; above 2 the terms are summed in slot order
    flat_tok, flat_y = tok_grid.reshape(-1), y_g.reshape(-1, d)
    if top_k <= 2:
        return torch.zeros((t, d), dtype=y_g.dtype,
                           device=x.device).index_add_(0, flat_tok, flat_y)
    out = torch.zeros((t, d), dtype=y_g.dtype, device=x.device)
    for i in range(flat_tok.shape[0]):
        out[flat_tok[i]] = out[flat_tok[i]] + flat_y[i]
    return out


def route(xf: torch.Tensor, router: torch.Tensor, n_experts: int,
          top_k: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs_full (t, E) float32, top_p (t, k) renormalized, top_idx (t,
    k)) for tokens xf (t, D): the float32 router product (TF32 off), its
    softmax, and the top k by a stable descending sort (ties to the lower
    expert index, as jax.lax.top_k)."""
    with exact_float32_matmul():
        logits = xf.to(torch.float32) @ router
    probs_full = torch.softmax(logits, dim=-1)
    top_p, top_idx = torch.sort(probs_full, dim=-1, descending=True,
                                stable=True)
    top_p, top_idx = top_p[:, :top_k], top_idx[:, :top_k]
    return probs_full, top_p / torch.sum(top_p, -1, keepdim=True), top_idx


def _check_mesh(tokens: int, cim: CIMConfig) -> None:
    """Raise where the JAX package would split the tokens or the experts
    over the ambient mesh (its shard_map path)."""
    mesh = get_mesh()
    if mesh is None or mesh.empty or cim.mode == "engine":
        return
    names = set(mesh.axis_names)
    n_batch = 1
    for a in BATCH:
        if a in names:
            n_batch *= mesh.axis_size(a)
    split_batch = n_batch > 1 and tokens % n_batch == 0
    split_model = TP in names and mesh.axis_size(TP) > 1
    if split_batch or split_model:
        raise NotImplementedError(
            f"moe_block under a mesh that splits its tokens or experts "
            f"({dict(zip(mesh.axis_names, mesh.shape))}) runs JAX's "
            f"shard_map path, which is not ported (ROADMAP Queue 1 "
            f"left-overs, the shard_map path of moe_block); run it in "
            f"engine mode or without the mesh")


def moe_block(params: Dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, cim: CIMConfig, act: str = "silu",
              key: Optional[torch.Tensor] = None, reference: bool = False
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (out (B, S, D), aux load-balance loss, a float32
    scalar).

    `key` (a host `core/prng` key) seeds the experts' CIM noise model (a
    fold per projection bank and per expert); `reference` runs the engine
    path's plain digital oracle in place of the kernels.  Engine mode
    always runs the local path (its programs own their sharding)."""
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    probs_full, top_p, top_idx = route(xf, params["router"], n_experts,
                                       top_k)
    top_p = top_p.to(x.dtype)
    # Switch-style load-balance aux loss
    me = torch.mean(probs_full, dim=0)
    ce = torch.mean(F.one_hot(top_idx[:, 0], n_experts).to(torch.float32),
                    dim=0)
    aux = n_experts * torch.sum(me * ce)
    _check_mesh(b * s, cim)
    out = _moe_local(
        xf, top_p, top_idx, _get_expert_w(params, "w_gate", x.dtype),
        _get_expert_w(params, "w_up", x.dtype),
        _get_expert_w(params, "w_down", x.dtype), params["abn_log_gamma"],
        params["abn_beta"], key, n_experts=n_experts, top_k=top_k,
        capacity_factor=capacity_factor, cim=cim, act=act,
        reference=reference)
    return out.reshape(b, s, d), aux

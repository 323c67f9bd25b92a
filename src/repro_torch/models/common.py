"""Shared building blocks of the LM path: norms, rotary embeddings,
attention (causal / sliding-window, streaming for long keys, over a KV
cache for decode), the KV caches and the MLP, every projection through
`core.cim_layers.cim_linear_apply`.

Counterpart of `repro/models/common.py`.  The JAX package's sharding
constraints stand where it puts them (`models/sharding.shard`, the
identity on a mesh folded onto one device), and `impl="pallas"`
attention goes through the context-parallel `flash_attention_sharded`.
Its caches are updated functionally; the port writes the K/V rings in
place, the PyTorch idiom, so a returned cache aliases the one passed in
(its "k" and "v" are the same tensors).  Cross-attention (`x_kv`,
`cross_kv`), the audio family's, follows JAX's: K/V from the encoder
states, or precomputed at prefill and read at decode.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.cim_layers import (CIMConfig, cim_linear_apply,
                                         init_cim_linear)
from repro_torch.models.sharding import BATCH, TP, shard

NEG_INF = -1e30    # masked score of the plain attention, as in JAX


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_norm(d: int, kind: str, device=None) -> Dict:
    """Parameters for a `kind` norm over a width-`d` feature axis
    (rmsnorm / layernorm / OLMo-style non-parametric layernorm)."""
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), device=device),
                "bias": torch.zeros((d,), device=device)}
    if kind == "nonparam_ln":          # OLMo: non-parametric LayerNorm
        return {}
    raise ValueError(kind)


def apply_norm(params: Dict, x: torch.Tensor, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalize the trailing feature axis in float32, cast back to
    x.dtype.  `kind` matches init_norm; the variance is the biased one,
    as jnp.var's."""
    xf = x.to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
        y = y * params["scale"]
    elif kind in ("layernorm", "nonparam_ln"):
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.var(xf, -1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if kind == "layernorm":
            y = y * params["scale"] + params["bias"]
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse rotary frequencies, shape (head_dim // 2,)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    if positions.dim() == 1:
        positions = positions[None, :]
    angles = positions[..., None].to(torch.float32) * inv_freq  # (B,S,D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                          causal: bool, window: int) -> torch.Tensor:
    """(..., Sq, Sk) boolean keep-mask from (..., Sq) and (..., Sk)
    positions (shared (Sq,)/(Sk,), or per batch row (B, Sq)/(B, Sk)); a
    key at a negative position is never kept."""
    rel = q_pos[..., :, None] - k_pos[..., None, :]
    valid = (k_pos >= 0)[..., None, :]
    keep = valid & (rel >= 0) if causal else valid.expand(rel.shape)
    if window > 0:
        keep = keep & (rel < window)
    return keep


def plain_attention(q, k, v, *, q_pos, k_pos, causal, window=0):
    """Reference attention; q (B, Sq, H, D), k/v (B, Sk, G, D).
    Materializes the scores.

    q_pos/k_pos are (Sq,)/(Sk,) shared across the batch, or (B, Sq)/(B,
    Sk) for per-row positions (slot-mapped in-flight decode, where every
    batch row sits at its own sequence offset): the keep-mask is then
    built per batch row."""
    b, sq, h, d = q.shape
    g = k.shape[2]
    rep = h // g
    qf = q.to(torch.float32) / (d ** 0.5)
    qf = qf.reshape(b, sq, g, rep, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.to(torch.float32))
    if q_pos.dim() == 2 or k_pos.dim() == 2:
        qp = q_pos if q_pos.dim() == 2 else q_pos[None].expand(b, sq)
        kp = k_pos if k_pos.dim() == 2 else k_pos[None].expand(
            b, k.shape[1])
        keep = attention_scores_mask(qp, kp, causal=causal, window=window)
        scores = torch.where(keep[:, None, None], scores, NEG_INF)
    else:
        keep = attention_scores_mask(q_pos, k_pos, causal=causal,
                                     window=window)
        scores = torch.where(keep, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.to(torch.float32))
    return out.reshape(b, sq, h, d).to(q.dtype)


def flash_attention(q, k, v, *, q_pos, k_pos, causal, window=0,
                    kv_block: int = 1024):
    """Streaming (online-softmax) attention over kv_block-key blocks:
    O(Sq * kv_block) live scores.  Shapes as plain_attention, positions
    shared across the batch.  The JAX package's `lax.scan` over the
    blocks, as a loop; keys padded to a whole block sit at position
    -10^9 and are never kept."""
    b, sq, h, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    rep = h // g
    if sk % kv_block:
        pad = kv_block - sk % kv_block
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-10**9)
        sk += pad
    qf = (q.to(torch.float32) / (d ** 0.5)).reshape(b, sq, g, rep, d)
    acc = torch.zeros((b, g, rep, sq, d), dtype=torch.float32,
                      device=q.device)
    m = torch.full((b, g, rep, sq), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, g, rep, sq), dtype=torch.float32, device=q.device)
    for s0 in range(0, sk, kv_block):
        kc, vc = k[:, s0:s0 + kv_block], v[:, s0:s0 + kv_block]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qf, kc.to(torch.float32))
        keep = attention_scores_mask(q_pos, k_pos[s0:s0 + kv_block],
                                     causal=causal, window=window)
        s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, -1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, -1)
        acc = acc * corr[..., None] + torch.einsum(
            "bgrqk,bkgd->bgrqd", p, vc.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    return out.to(q.dtype)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    """Static attention-block hyperparameters (GQA shape, RoPE, window,
    flash threshold, kernel implementation)."""
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    window: int = 0                    # >0: sliding-window attention
    causal: bool = True
    rope_theta: float = 1e6
    use_rope: bool = True
    flash_threshold: int = 8192        # Sk above which JAX streams
    impl: str = "jnp"                  # jnp | pallas (the flash kernels)


def init_attention(generator: torch.Generator, cfg: AttnConfig,
                   cim: Optional[CIMConfig] = None) -> Dict:
    """Q/K/V/O projection params (CIM-linear layout) + optional biases, on
    the generator's device."""
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": init_cim_linear(generator, d, h * hd, cfg=cim),
        "wk": init_cim_linear(generator, d, g * hd, cfg=cim),
        "wv": init_cim_linear(generator, d, g * hd, cfg=cim),
        "wo": init_cim_linear(generator, h * hd, d, cfg=cim),
    }
    if cfg.qkv_bias:
        dev = generator.device
        p["bq"] = torch.zeros((h * hd,), device=dev)
        p["bk"] = torch.zeros((g * hd,), device=dev)
        p["bv"] = torch.zeros((g * hd,), device=dev)
    return p


def _repeat_kv_to(x: torch.Tensor, target_heads: int) -> torch.Tensor:
    """Repeat KV heads (B, S, G, D) -> (B, S, target_heads, D) so the head
    axis divides a tensor-parallel mesh axis: each head repeated in
    place, as jnp.repeat does (no-op when G >= target_heads)."""
    g = x.shape[2]
    if g >= target_heads:
        return x
    return torch.repeat_interleave(x, target_heads // g, dim=2)


def attention_block(params: Dict, x: torch.Tensor, cfg: AttnConfig,
                    cim: CIMConfig, *, positions: torch.Tensor,
                    cache: Optional[Dict] = None,
                    kv_repeat_to: int = 0,
                    x_kv: Optional[torch.Tensor] = None,
                    cross_kv: Optional[Dict] = None,
                    kv_positions: Optional[torch.Tensor] = None,
                    key: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Causal (or, with cfg.causal False, bidirectional) self-attention,
    or cross-attention over `x_kv`; x (B, S, d_model) -> (out (B, S,
    d_model), new_cache).

    Without a cache, with cfg.impl == "pallas" and more than one query
    position the attention runs on the flash kernels (forward and
    backward, `flash_attention_sharded`: split over the ambient mesh
    where it divides the shapes), with masks from the positions 0..S-1;
    otherwise, as with a
    cache, on `plain_attention`, or on the streaming `flash_attention`
    when more than one query meets more than cfg.flash_threshold keys.
    new_cache is None without a cache.

    With a cache from `init_kv_cache` (one shared 0-d write cursor
    "idx") the S new K/V rows are written into the ring at idx % L, the
    start clamped so that they fit (as jax.lax.dynamic_update_slice
    clamps it), and the queries attend over the whole ring with each
    slot's position.  With a slot-mapped cache from `init_slot_kv_cache`
    (a (B,) per-slot cursor) each batch row writes its one token (S
    must be 1) at its own cursor and attends with its own positions
    (`positions` (B, 1)).  The rings are written in place: the returned
    cache holds the same "k" and "v" tensors and a new cursor idx + S.
    K/V are stored in the cache's dtype.

    Cross-attention (the audio family), as in JAX: with `x_kv` (B, Sk,
    d_model), the encoder states, K/V are projected from it at the
    positions `kv_positions` (default 0..Sk-1), never causal, with no
    window and no RoPE; a cache of {} then returns {"k", "v"} (B, Sk, G,
    D), the projected K/V in the compute dtype, for decode.  With
    `cross_kv` ({"k", "v"}, precomputed) the queries attend over it at
    positions 0..Sk-1 with no K/V projection, on the plain attention,
    and it is returned as the new cache.

    `kv_repeat_to` (> G) repeats the K/V heads to that many after RoPE,
    before the cache write, so the head axis divides a tensor-parallel
    axis (a cache then holds the repeated heads).

    `key` seeds the CIM noise model of the four projections
    (fold_in(key, i) for q, k, v, o); None keeps them clean."""
    b, s, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    src = x if x_kv is None else x_kv
    kq = kk = kv = ko = None
    if key is not None:
        kq, kk, kv, ko = (prng.fold_in(key, i) for i in range(4))
    causal = cfg.causal and x_kv is None
    window = cfg.window if x_kv is None else 0

    use_pallas = (cfg.impl == "pallas" and s > 1 and cache is None
                  and cross_kv is None)
    q = cim_linear_apply(params["wq"], x, cim, key=kq)
    if "bq" in params:
        q = q + params["bq"]
    q = q.reshape(b, s, h, hd)
    if not use_pallas:
        # the pallas path's pieces define the layout themselves
        q = shard(q, BATCH, None, TP, None)
    if cross_kv is not None:
        # cross-attention decode: the encoder's K/V, projected at prefill
        k, v = cross_kv["k"], cross_kv["v"]
        k_pos = torch.arange(k.shape[1], device=x.device)
        new_cache = cross_kv
    else:
        sk = src.shape[1]
        k = cim_linear_apply(params["wk"], src, cim, key=kk)
        v = cim_linear_apply(params["wv"], src, cim, key=kv)
        if "bk" in params:
            k, v = k + params["bk"], v + params["bv"]
        k = k.reshape(b, sk, g, hd)
        v = v.reshape(b, sk, g, hd)
        k_pos = positions if x_kv is None else (
            kv_positions if kv_positions is not None
            else torch.arange(sk, device=x.device))
        if cfg.use_rope and x_kv is None:
            inv = rope_frequencies(hd, cfg.rope_theta, device=x.device)
            q = apply_rope(q, positions, inv)
            k = apply_rope(k, positions, inv)
        if kv_repeat_to:
            k = _repeat_kv_to(k, kv_repeat_to)
            v = _repeat_kv_to(v, kv_repeat_to)
        new_cache = None
        if cache is not None and x_kv is not None:
            # cross-attention prefill: the K/V become the decode's cross_kv
            new_cache = {"k": k, "v": v}
        elif cache is not None and cache["idx"].dim() == 1:
            # slot-mapped decode: every batch row writes one token at its
            # own ring cursor and attends with its own (B, L) positions
            if s != 1:
                raise ValueError(
                    f"slot-mapped KV decode is single-token (s=1), got "
                    f"s={s}; prefill per request and scatter into the slot "
                    "with write_slot_kv")
            length = cache["k"].shape[1]
            idx = cache["idx"]
            write = torch.remainder(idx, length).long()
            rows = torch.arange(b, device=x.device)
            cache["k"][rows, write] = k[:, 0].to(cache["k"].dtype)
            cache["v"][rows, write] = v[:, 0].to(cache["v"].dtype)
            k = shard(cache["k"], BATCH, TP, None, None)
            v = shard(cache["v"], BATCH, TP, None, None)
            new_cache = {"k": k, "v": v, "idx": idx + s}
            j = torch.arange(length, device=x.device)[None, :]
            last = (idx + s - 1)[:, None].long()
            k_pos = last - torch.remainder(last - j, length)
            k_pos = torch.where(k_pos >= 0, k_pos, -10**9)
        elif cache is not None:
            # ring-buffer append at idx % L (multi-token prefill into the
            # cache needs idx + s <= L)
            length = cache["k"].shape[1]
            idx = cache["idx"]
            write = torch.remainder(idx, length).long()
            start = torch.clamp(write, 0, length - s)
            slots = start + torch.arange(s, device=x.device)
            cache["k"].index_copy_(1, slots, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, slots, v.to(cache["v"].dtype))
            k = shard(cache["k"], BATCH, TP, None, None)
            v = shard(cache["v"], BATCH, TP, None, None)
            new_cache = {"k": k, "v": v, "idx": idx + s}
            j = torch.arange(length, device=x.device)
            last = (idx + s - 1).long()
            k_pos = last - torch.remainder(last - j, length)
            k_pos = torch.where(k_pos >= 0, k_pos, -10**9)
        if (cache is None or x_kv is not None) and not use_pallas:
            k = shard(k, BATCH, None, TP, None)
            v = shard(v, BATCH, None, TP, None)

    # per-slot decode keeps (B, S) query positions so the per-row masks
    # line up; otherwise (B, S) positions collapse to row 0 (shared)
    per_row = k_pos.dim() == 2
    q_pos = positions if (positions.dim() == 1 or per_row) else positions[0]
    if use_pallas:
        from repro_torch.kernels.flash_attn.ops import \
            flash_attention_sharded
        out = flash_attention_sharded(q, k, v, causal, window)
    elif k.shape[1] > cfg.flash_threshold and s > 1:
        # the streaming path takes positions shared across the batch
        if per_row:
            q_pos, k_pos = q_pos[0], k_pos[0]
        out = flash_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                              causal=causal, window=window)
    else:
        out = plain_attention(q, k, v, q_pos=q_pos, k_pos=k_pos,
                              causal=causal and s > 1, window=window)
    y = cim_linear_apply(params["wo"], out.reshape(b, s, h * hd), cim,
                         key=ko)
    return shard(y, BATCH, None, None), new_cache


def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> Dict:
    """Ring-buffer decode cache with one shared write cursor (all batch
    rows advance in lockstep, the classic static-batch serving shape):
    zeroed "k"/"v" (batch, max_len, n_kv, head_dim) and a 0-d int32
    "idx"."""
    return {"k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                             device=device),
            "idx": torch.zeros((), dtype=torch.int32, device=device)}


def init_slot_kv_cache(slots: int, max_len: int, n_kv: int, head_dim: int,
                       dtype=torch.bfloat16, device=None) -> Dict:
    """Slot-mapped decode cache for in-flight (continuous) batching: the
    layout of init_kv_cache with a (slots,) int32 per-slot write cursor,
    so requests at different sequence offsets decode fused in one batch.
    Admit a request with write_slot_kv, retire it with free_slot_kv."""
    return {"k": torch.zeros((slots, max_len, n_kv, head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((slots, max_len, n_kv, head_dim), dtype=dtype,
                             device=device),
            "idx": torch.zeros((slots,), dtype=torch.int32, device=device)}


def write_slot_kv(cache: Dict, slot: int, prefill: Dict) -> Dict:
    """Admit one request: copy its prefilled batch-1 cache (an
    init_kv_cache it was prefilled into) into `slot` and set the slot's
    cursor to the prefill's.  Every other slot is left as it was.
    Writes in place: the returned cache aliases `cache`."""
    cache["k"][slot] = prefill["k"][0].to(cache["k"].dtype)
    cache["v"][slot] = prefill["v"][0].to(cache["v"].dtype)
    cache["idx"][slot] = prefill["idx"]
    return {"k": cache["k"], "v": cache["v"], "idx": cache["idx"]}


def free_slot_kv(cache: Dict, slot: int) -> Dict:
    """Retire one request: reset the slot's write cursor to 0.  Its stale
    K/V rows stay in place (a zero cursor masks every ring position but
    the next write, and the next admission overwrites them), so
    retirement moves no cache data.  Writes in place: the returned cache
    aliases `cache`."""
    cache["idx"][slot] = 0
    return {"k": cache["k"], "v": cache["v"], "idx": cache["idx"]}


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class _Silu(torch.autograd.Function):
    """jax.nn.silu as XLA runs it, forward and backward, every step rounded
    to the input's dtype: s = 1 / (1 + exp(-x)) (XLA's expansion of the
    logistic), y = x * s, and the cotangent g * s + (x * g) * (s * (1 - s))
    (the JAX vjp).  In bfloat16 both equal the JAX package bit for bit;
    F.silu, which rounds once, differs on many elements, and each such ulp
    can move a fakequant code of the next projection."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        return g * s + (x * g) * (s * (1 - s))


_ACTIVATIONS = {
    "silu": _Silu.apply,
    "gelu": lambda v: F.gelu(v, approximate="tanh"),   # jax.nn.gelu
    "relu2": lambda v: torch.square(F.relu(v)),
}


def activation_fn(name: str):
    """The MLP activation table (silu / gelu / relu2).  Every function
    preserves the input dtype.  Raises ValueError on an unknown name."""
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(
            f"unknown activation {name!r}; expected one of "
            f"{sorted(_ACTIVATIONS)}") from None


def init_mlp(generator: torch.Generator, d: int, f: int, gated: bool,
             cim: Optional[CIMConfig] = None) -> Dict:
    """Up/down (+ optional gate) projection params for a d->f->d MLP."""
    p = {"w_up": init_cim_linear(generator, d, f, cfg=cim),
         "w_down": init_cim_linear(generator, f, d, cfg=cim)}
    if gated:
        p["w_gate"] = init_cim_linear(generator, d, f, cfg=cim)
    return p


def mlp_block(params: Dict, x: torch.Tensor, cim: CIMConfig,
              act: str = "silu",
              key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Gated) MLP with every projection through the CIM path.  `key`
    seeds the projections' noise model (fold_in(key, i) for up, gate,
    down)."""
    k_up = k_gate = k_down = None
    if key is not None:
        k_up, k_gate, k_down = (prng.fold_in(key, i) for i in range(3))
    up = cim_linear_apply(params["w_up"], x, cim, key=k_up)
    up = shard(up, BATCH, None, TP)
    fn = activation_fn(act)
    if "w_gate" in params:
        gate = cim_linear_apply(params["w_gate"], x, cim, key=k_gate)
        gate = shard(gate, BATCH, None, TP)
        hidden = fn(gate) * up
    else:
        hidden = fn(up)
    y = cim_linear_apply(params["w_down"], hidden, cim, key=k_down)
    return shard(y, BATCH, None, None)

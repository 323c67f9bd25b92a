"""Shared building blocks of the LM path: norms, rotary embeddings, the
cache-free attention block and the MLP, every projection through
`core.cim_layers.cim_linear_apply`.

Counterpart of `repro/models/common.py` for training: the JAX package's
sharding constraints are dropped (the port runs on one card), and so are
the branches the training forward never takes: the KV caches,
cross-attention and the KV-head repeat for sharding are not ported, and
the streaming attention (keys past `flash_threshold` on the plain path)
raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.cim_layers import (CIMConfig, cim_linear_apply,
                                         init_cim_linear)

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
    """(Sq, Sk) boolean keep-mask from (Sq,) and (Sk,) positions; a key
    at a negative position is never kept."""
    rel = q_pos[:, None] - k_pos[None, :]
    valid = (k_pos >= 0)[None, :]
    keep = valid & (rel >= 0) if causal else valid.expand(rel.shape)
    if window > 0:
        keep = keep & (rel < window)
    return keep


def plain_attention(q, k, v, *, q_pos, k_pos, causal, window=0):
    """Reference attention; q (B, Sq, H, D), k/v (B, Sk, G, D), positions
    (Sq,)/(Sk,) shared across the batch.  Materializes the scores."""
    b, sq, h, d = q.shape
    g = k.shape[2]
    rep = h // g
    qf = q.to(torch.float32) / (d ** 0.5)
    qf = qf.reshape(b, sq, g, rep, d)
    scores = torch.einsum("bqgrd,bkgd->bgrqk", qf, k.to(torch.float32))
    keep = attention_scores_mask(q_pos, k_pos, causal=causal, window=window)
    scores = torch.where(keep, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.to(torch.float32))
    return out.reshape(b, sq, h, d).to(q.dtype)


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


def attention_block(params: Dict, x: torch.Tensor, cfg: AttnConfig,
                    cim: CIMConfig, *, positions: torch.Tensor,
                    key: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal (or, with cfg.causal False, bidirectional) self-attention
    without a KV cache: x (B, S, d_model) -> (B, S, d_model).

    With cfg.impl == "pallas" and more than one query position the
    attention runs on the flash kernels (forward and backward), with masks
    from the positions 0..S-1; otherwise on `plain_attention`.  `key`
    seeds the CIM noise model of the four projections (fold_in(key, i)
    for q, k, v, o); None keeps them clean."""
    b, s, _ = x.shape
    h, g, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kq = kk = kv = ko = None
    if key is not None:
        kq, kk, kv, ko = (prng.fold_in(key, i) for i in range(4))

    q = cim_linear_apply(params["wq"], x, cim, key=kq)
    k = cim_linear_apply(params["wk"], x, cim, key=kk)
    v = cim_linear_apply(params["wv"], x, cim, key=kv)
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, g, hd)
    v = v.reshape(b, s, g, hd)
    if cfg.use_rope:
        inv = rope_frequencies(hd, cfg.rope_theta, device=x.device)
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)

    if cfg.impl == "pallas" and s > 1:
        from repro_torch.kernels.flash_attn.ops import flash_attention
        out = flash_attention(q, k, v, cfg.causal, cfg.window)
    elif s > cfg.flash_threshold:
        raise NotImplementedError(
            "the streaming attention (keys past flash_threshold) is not "
            "ported; use impl='pallas'")
    else:
        pos = positions if positions.dim() == 1 else positions[0]
        out = plain_attention(q, k, v, q_pos=pos, k_pos=pos,
                              causal=cfg.causal and s > 1,
                              window=cfg.window)
    return cim_linear_apply(params["wo"], out.reshape(b, s, h * hd), cim,
                            key=ko)


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
    fn = activation_fn(act)
    if "w_gate" in params:
        gate = cim_linear_apply(params["w_gate"], x, cim, key=k_gate)
        hidden = fn(gate) * up
    else:
        hidden = fn(up)
    return cim_linear_apply(params["w_down"], hidden, cim, key=k_down)

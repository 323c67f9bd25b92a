"""Plain PyTorch versions of the attention kernels.

Ring-decode attention, the counterpart of `ring_decode_attention_ref` in
`repro/kernels/flash_attn/ops.py`:

    softmax(q . k / sqrt(hd) + bias) . v

per row over the row's own KV ring, q (R, H, hd), k/v (R, L, H, hd),
bias (R, L) additive (0 for a written slot, -1e9 for one not written
yet) -> (R, H, hd), all float32.  It is the CPU path of the kernel
wrapper and the yardstick the CUDA kernel is held to on the card.

Rows are computed one at a time, each as a one-row problem, so a row's
result never depends on how many rows the call has (a batched product or
a vectorized elementwise pass may take another path at another extent).
Fused in-flight decode equals solo decode through this function bit for
bit, on the CPU as on the card.

The flash forward and backward (training) follow below.
"""
from __future__ import annotations

import math

import torch


def ring_decode_attention_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              bias: torch.Tensor) -> torch.Tensor:
    """q (R, H, hd), k/v (R, L, H, hd), bias (R, L) -> (R, H, hd).

    The op order is the JAX reference's: scores divided by sqrt(hd) (an
    IEEE divide by a device tensor, not a reciprocal multiply), plus the
    bias, softmax over the slots, then the probability-weighted sum of v.
    """
    hd = q.shape[-1]
    scale = torch.tensor(math.sqrt(hd), dtype=torch.float32, device=q.device)
    outs = []
    for r in range(q.shape[0]):
        scores = torch.einsum("hd,lhd->hl", q[r], k[r]) / scale
        probs = torch.softmax(scores + bias[r][None, :], dim=-1)
        outs.append(torch.einsum("hl,lhd->hd", probs, v[r]))
    if not outs:
        return torch.empty_like(q)
    return torch.stack(outs)


# ---------------------------------------------------------------------------
# flash attention (training forward and backward)
# ---------------------------------------------------------------------------
#
# Plain versions of the three flash kernels, counterparts of
# `repro/kernels/flash_attn/kernel.py`'s `_flash_kernel`,
# `_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`.  q (B, H, Sq, D) and
# k/v (B, G, Sk, D) with H = G * rep (query head h reads kv head h // rep),
# in any float dtype, computed in float32.  They follow the kernels' float
# conventions: a masked score is NEG_INF = -1e30 (not -inf), l is clamped
# to 1e-30, the forward scales q before the dot and the backward scales the
# dot.  The forward is the one-tile form of the online softmax, so a row
# that keeps no key averages v over all Sk keys, as the CUDA kernel does.

NEG_INF = -1e30


def flash_keep_mask(sq: int, sk: int, q_off: torch.Tensor, *, causal: bool,
                    window: int) -> torch.Tensor:
    """(Sq, Sk) bool keep-mask of the flash kernels: query row i sits at
    global position q_off + i (q_off a one-element int tensor), key j at j;
    causal keeps j <= q_off + i, a window > 0 keeps q_off + i - j <
    window."""
    dev = q_off.device
    q_pos = q_off.reshape(()).to(torch.int64) + torch.arange(sq, device=dev)
    rel = q_pos[:, None] - torch.arange(sk, device=dev)[None, :]
    keep = rel >= 0 if causal else torch.ones_like(rel, dtype=torch.bool)
    if window > 0:
        keep = keep & (rel < window)
    return keep


def _kv_heads(t: torch.Tensor, rep: int) -> torch.Tensor:
    """(B, G, S, D) -> (B, G * rep, S, D) float32: kv head g serves query
    heads g * rep .. g * rep + rep - 1."""
    t = t.float()
    return t.repeat_interleave(rep, dim=1) if rep > 1 else t


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_off: torch.Tensor, *, causal: bool, window: int = 0):
    """Attention forward: returns O (B, H, Sq, D) in q's dtype and the row
    logsumexp lse (B, H, Sq) float32."""
    d = q.shape[-1]
    rep = q.shape[1] // k.shape[1]
    scale = 1.0 / (d ** 0.5)
    s = torch.matmul(q.float() * scale, _kv_heads(k, rep).transpose(-1, -2))
    keep = flash_keep_mask(q.shape[2], k.shape[2], q_off, causal=causal,
                           window=window)
    s = torch.where(keep, s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), 1e-30)
    o = torch.matmul(p, _kv_heads(v, rep)) / l_safe
    return o.to(q.dtype), (m + torch.log(l_safe))[..., 0]


def _bwd_probs(q, k, v, do, lse, delta, q_off, causal, window):
    """p and ds of the backward kernels, (B, H, Sq, Sk) float32, and k
    per query head."""
    d = q.shape[-1]
    rep = q.shape[1] // k.shape[1]
    scale = 1.0 / (d ** 0.5)
    kf = _kv_heads(k, rep)
    s = scale * torch.matmul(q.float(), kf.transpose(-1, -2))
    keep = flash_keep_mask(q.shape[2], k.shape[2], q_off, causal=causal,
                           window=window)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(do.float(), _kv_heads(v, rep).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    return p, ds, kf


def flash_bwd_dq_ref(q, k, v, do, lse, delta, q_off, *, causal: bool,
                     window: int = 0) -> torch.Tensor:
    """dq (B, H, Sq, D) float32 = ds . k, p recomputed from lse; do like
    q, lse and delta = rowsum(dO * O) (B, H, Sq) float32."""
    _, ds, kf = _bwd_probs(q, k, v, do, lse, delta, q_off, causal, window)
    return torch.matmul(ds, kf)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, q_off, *, causal: bool,
                      window: int = 0):
    """dk = ds^T . q and dv = p^T . dO, per query head: (B, H, Sk, D)
    float32 each (the caller sums each kv group's rep heads)."""
    p, ds, _ = _bwd_probs(q, k, v, do, lse, delta, q_off, causal, window)
    return (torch.matmul(ds.transpose(-1, -2), q.float()),
            torch.matmul(p.transpose(-1, -2), do.float()))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: int = 0,
                  sk_valid: int = 0) -> torch.Tensor:
    """Softmax attention, the oracle the flash kernels are held to
    (`repro/kernels/flash_attn/ref.py:attention_ref`): q (B, H, Sq, D),
    k/v (B, G, Sk, D) -> (B, H, Sq, D) in q's dtype.  Keys at or past
    `sk_valid` (0: none) are masked."""
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    rep = q.shape[1] // k.shape[1]
    sk_valid = sk_valid or sk
    s = torch.matmul(q.float() / (d ** 0.5),
                     _kv_heads(k, rep).transpose(-1, -2))
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    keep = k_pos < sk_valid
    if causal:
        keep = keep & (q_pos >= k_pos)
    if window > 0:
        keep = keep & ((q_pos - k_pos) < window)
    p = torch.softmax(torch.where(keep, s, NEG_INF), dim=-1)
    return torch.matmul(p, _kv_heads(v, rep)).to(q.dtype)

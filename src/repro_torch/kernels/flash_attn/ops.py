"""Public entries of the attention kernels.

Counterpart of `repro/kernels/flash_attn/ops.py`:

- `flash_attention` is the training (cache-free) attention of
  `models/common.attention_block` with `impl="pallas"`: the hand-written
  flash forward and backward kernels as one `torch.autograd.Function`,
  in place of the JAX package's `_flash_core` custom VJP.
- `ring_decode_attention` serves every `CIMDecodeLM` decode step (one
  query per row, each row attending only to its own KV ring, slot
  validity given as an additive bias); `ring_decode_attention_ref` is the
  plain version it is held to.

The context-parallel `flash_attention_sharded` waits for the port of
sharding; without a mesh it is `flash_attention`, which the port calls.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attn.kernel import (flash_bwd_dkv,
                                                   flash_bwd_dq, flash_fwd,
                                                   ring_decode)
from repro_torch.kernels.flash_attn.ref import ring_decode_attention_ref

__all__ = ["flash_attention", "ring_decode_attention",
           "ring_decode_attention_ref"]


class _FlashAttention(torch.autograd.Function):
    """Forward and backward through the flash kernels.  The tensors keep
    the model's (B, S, H, D) layout; the kernels read them through strides
    as (B, H, S, D), so nothing is transposed in memory."""

    @staticmethod
    def forward(ctx, q, k, v, q_off, causal: bool, window: int):
        o, lse = flash_fwd(q.transpose(1, 2), k.transpose(1, 2),
                           v.transpose(1, 2), q_off, causal=causal,
                           window=window)
        out = o.transpose(1, 2)
        ctx.save_for_backward(q, k, v, q_off, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, q_off, out, lse = ctx.saved_tensors
        b, _, h, d = q.shape
        sk, g = k.shape[1], k.shape[2]
        rep = h // g
        if g_out.stride(-1) != 1:
            g_out = g_out.contiguous()
        # delta_i = rowsum(dO * O), (B, H, Sq) float32, as ops._bwd
        delta = torch.sum(g_out.float() * out.float(), dim=-1) \
            .transpose(1, 2).contiguous()
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                g_out.transpose(1, 2), lse, delta, q_off)
        kw = dict(causal=ctx.causal, window=ctx.window)
        dq = flash_bwd_dq(*args, **kw)
        dk_h, dv_h = flash_bwd_dkv(*args, **kw)
        dq = dq.transpose(1, 2).to(q.dtype)
        # per-query-head dk/dv summed over each kv group's rep heads
        dk = dk_h.transpose(1, 2).reshape(b, sk, g, rep, d).sum(3)
        dv = dv_h.transpose(1, 2).reshape(b, sk, g, rep, d).sum(3)
        return dq, dk.to(k.dtype), dv.to(v.dtype), None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_offset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, Sq, H, D); k/v (B, Sk, G, D) with G dividing H.  Returns
    (B, Sq, H, D) in q's dtype, differentiable in q, k and v.

    `q_offset` is the global position of query row 0, a (1, 1) int32 on
    q's device (default 0).  The CUDA kernels choose their own tiles, so
    the TPU kernel's block sizes `bq`/`bk` have no counterpart here."""
    if q_offset is None:
        q_offset = torch.zeros((1, 1), dtype=torch.int32, device=q.device)
    return _FlashAttention.apply(q, k, v, q_offset, bool(causal),
                                 int(window))


def ring_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Ring-buffer decode attention: q (R, H, hd), k/v (R, L, H, hd), bias
    (R, L) -> (R, H, hd) float32.  The CUDA kernel on the card, the plain
    version on the CPU; row r of the result never depends on the other
    rows."""
    return ring_decode(q, k, v, bias)

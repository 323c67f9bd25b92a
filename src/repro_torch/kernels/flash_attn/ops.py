"""Public entries of the attention kernels.

Counterpart of `repro/kernels/flash_attn/ops.py`:

- `flash_attention` is the cache-free attention of the flash kernels:
  the hand-written forward and backward kernels as one
  `torch.autograd.Function`, in place of the JAX package's `_flash_core`
  custom VJP.
- `flash_attention_sharded` is the context-parallel entry that
  `models/common.attention_block` calls with `impl="pallas"`: over the
  ambient mesh (`models/sharding.use_mesh`) q splits along the sequence
  over "model" and along the batch over "pod"/"data", and each piece goes
  through the same kernels with its own q offset.  Without a mesh, or
  where the mesh splits nothing, it is `flash_attention`.
- `ring_decode_attention` serves every `CIMDecodeLM` decode step (one
  query per row, each row attending only to its own KV ring, slot
  validity given as an additive bias); `ring_decode_attention_ref` is the
  plain version it is held to.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attn.kernel import (flash_bwd_dkv,
                                                   flash_bwd_dq, flash_fwd,
                                                   ring_decode)
from repro_torch.kernels.flash_attn.ref import ring_decode_attention_ref

__all__ = ["flash_attention", "flash_attention_sharded",
           "ring_decode_attention", "ring_decode_attention_ref"]


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


def sharded_pieces(mesh, b: int, sq: int) -> Optional[list]:
    """The pieces `flash_attention_sharded` splits a (B, Sq, ...) query
    into on `mesh`, as the JAX package's shard_map specs split it: the
    batch over the mesh's "pod"/"data" axes (dropped when their product
    does not divide B), the sequence over "model" (dropped when it does
    not divide Sq or leaves fewer than 128 rows a piece).  Each piece is
    (batch slice, sequence slice, q offset, device): the device at the
    piece's mesh coordinate, every axis it does not split at index 0.
    None when nothing splits (no mesh, or an empty one)."""
    if mesh is None or mesh.empty:
        return None
    names = mesh.axis_names
    ba = tuple(a for a in ("pod", "data") if a in names)
    n_b = math.prod(mesh.axis_size(a) for a in ba)
    if b % max(n_b, 1):
        ba, n_b = (), 1
    n_tp = mesh.axis_size("model") if "model" in names else 1
    tp = "model" in names and not sq % n_tp and sq // n_tp >= 128
    if not tp:
        n_tp = 1
    if n_b == 1 and n_tp == 1:
        return None
    bw, sw = b // n_b, sq // n_tp
    pieces = []
    for bi in range(n_b):
        coord = dict.fromkeys(names, 0)
        rest = bi
        for a in reversed(ba):           # row-major over the batch axes
            coord[a] = rest % mesh.axis_size(a)
            rest //= mesh.axis_size(a)
        for ti in range(n_tp):
            if tp:
                coord["model"] = ti
            flat = 0
            for a, n in zip(names, mesh.shape):
                flat = flat * n + coord[a]
            pieces.append((slice(bi * bw, (bi + 1) * bw),
                           slice(ti * sw, (ti + 1) * sw), ti * sw,
                           mesh.devices[flat]))
    return pieces


def _piece(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A (B, S, H, D) piece as the kernels read it, (B, H, S, D), on the
    piece's device."""
    return t.to(dev).transpose(1, 2)


def sharded_forward(q, k, v, causal: bool, window: int, pieces):
    """The forward of `flash_attention_sharded` over `pieces`
    (`sharded_pieces`): O (B, Sq, H, D) in q's dtype and lse (B, H, Sq)
    float32, each piece through `flash_fwd` with its q offset on its
    device, gathered on q's device."""
    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    for bs, ss, off, dev in pieces:
        q_off = torch.full((1, 1), off, dtype=torch.int32, device=dev)
        op, lp = flash_fwd(_piece(q[bs, ss], dev), _piece(k[bs], dev),
                           _piece(v[bs], dev), q_off, causal=causal,
                           window=window)
        o[bs, ss] = op.transpose(1, 2).to(q.device)
        lse[bs, :, ss] = lp.to(q.device)
    return o, lse


def sharded_backward(q, k, v, o, lse, g_out, causal: bool, window: int,
                     pieces):
    """The backward of `flash_attention_sharded` over `pieces`: dq
    (B, H, Sq, D) and the per-query-head dk, dv (B, H, Sk, D), all
    float32, each piece through `flash_bwd_dq` and `flash_bwd_dkv` with
    its q offset.  A sequence piece's dk and dv are partial sums over its
    queries; they add up in float32, in piece order, before any cast."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    # delta_i = rowsum(dO * O), (B, H, Sq) float32, as ops._bwd
    delta = torch.sum(g_out.float() * o.float(), dim=-1).transpose(1, 2)
    dq = torch.empty((b, h, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for bs, ss, off, dev in pieces:
        q_off = torch.full((1, 1), off, dtype=torch.int32, device=dev)
        args = (_piece(q[bs, ss], dev), _piece(k[bs], dev),
                _piece(v[bs], dev), _piece(g_out[bs, ss], dev),
                lse[bs, :, ss].to(dev).contiguous(),
                delta[bs, :, ss].to(dev).contiguous(), q_off)
        kw = dict(causal=causal, window=window)
        dq[bs, :, ss] = flash_bwd_dq(*args, **kw).to(q.device)
        dk_p, dv_p = flash_bwd_dkv(*args, **kw)
        dk[bs] += dk_p.to(q.device)
        dv[bs] += dv_p.to(q.device)
    return dq, dk, dv


class _ShardedFlash(torch.autograd.Function):
    """`flash_attention` split into pieces (`sharded_pieces`), forward
    and backward through the kernels piece by piece."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, pieces):
        o, lse = sharded_forward(q, k, v, causal, window, pieces)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.window, ctx.pieces = causal, window, pieces
        return o

    @staticmethod
    def backward(ctx, g_out):
        q, k, v, o, lse = ctx.saved_tensors
        b, _, h, d = q.shape
        sk, g = k.shape[1], k.shape[2]
        if g_out.stride(-1) != 1:
            g_out = g_out.contiguous()
        dq, dk_h, dv_h = sharded_backward(q, k, v, o, lse, g_out,
                                          ctx.causal, ctx.window,
                                          ctx.pieces)
        # per-query-head dk/dv summed over each kv group's rep heads
        dk = dk_h.transpose(1, 2).reshape(b, sk, g, h // g, d).sum(3)
        dv = dv_h.transpose(1, 2).reshape(b, sk, g, h // g, d).sum(3)
        return (dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype), None, None, None)


def flash_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool = True,
                            window: int = 0) -> torch.Tensor:
    """Context-parallel flash attention over the ambient mesh
    (`models/sharding.use_mesh`): q (B, Sq, H, D) split along the
    sequence over "model" and along the batch over "pod"/"data", k/v
    (B, Sk, G, D) whole for every sequence piece.  Each piece runs the
    flash kernels with its own q offset, on its mesh device, and the
    output gathers on q's device; gradients flow through the pieces (a
    sequence piece's dk/dv partials add up in float32 before the cast).
    Falls back to `flash_attention` where the JAX package does: no mesh,
    or shapes the mesh does not divide (`sharded_pieces`)."""
    from repro_torch.models.sharding import get_mesh
    pieces = sharded_pieces(get_mesh(), q.shape[0], q.shape[1])
    if pieces is None:
        return flash_attention(q, k, v, causal, window)
    return _ShardedFlash.apply(q, k, v, bool(causal), int(window), pieces)


def ring_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Ring-buffer decode attention: q (R, H, hd), k/v (R, L, H, hd), bias
    (R, L) -> (R, H, hd) float32.  The CUDA kernel on the card, the plain
    version on the CPU; row r of the result never depends on the other
    rows."""
    return ring_decode(q, k, v, bias)

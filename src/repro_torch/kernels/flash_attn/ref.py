"""Plain PyTorch version of the ring-decode attention kernel.

Counterpart of `ring_decode_attention_ref` in
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

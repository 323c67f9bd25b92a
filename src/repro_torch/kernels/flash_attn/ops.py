"""Public entry of ring-buffer decode attention.

Counterpart of the ring-decode half of `repro/kernels/flash_attn/ops.py`:
`ring_decode_attention` serves every `CIMDecodeLM` decode step (one query
per row, each row attending only to its own KV ring, slot validity given
as an additive bias); `ring_decode_attention_ref` is the plain version it
is held to.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.kernel import ring_decode
from repro_torch.kernels.flash_attn.ref import ring_decode_attention_ref

__all__ = ["ring_decode_attention", "ring_decode_attention_ref"]


def ring_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Ring-buffer decode attention: q (R, H, hd), k/v (R, L, H, hd), bias
    (R, L) -> (R, H, hd) float32.  The CUDA kernel on the card, the plain
    version on the CPU; row r of the result never depends on the other
    rows."""
    return ring_decode(q, k, v, bias)

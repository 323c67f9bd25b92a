"""Activation and weight quantizers of the CIM datapath.

Counterpart of `repro/core/quantization.py` for the inference path:
activations are quantized to r_in unsigned bits with an *adaptive swing*
(the dynamic scale plays the role of the serial-split DPL configuration +
signed-to-unsigned conversion), weights to the macro's odd-integer +/-1
bit-plane grid.

The float chain is held bit for bit to the JAX package: scales multiply by
the f32-rounded reciprocal of the level count (`_static_reciprocal`), the
activation divide `(x - zero) / scale` is an IEEE divide whose divisor is a
tensor on the operand's device, and rounding is half-to-even
(`torch.round`, like `jnp.round`).  Eager PyTorch runs each operator as its
own kernel and never fuses or contracts them, so the JAX package's
`rounding_barrier` has no counterpart here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


def _static_reciprocal(levels: float) -> float:
    """f32-rounded 1/levels as a Python constant (the JAX package bakes the
    same float into every graph that quantizes the same tensor)."""
    return float(np.float32(1.0) / np.float32(levels))


class ActQuant(NamedTuple):
    """x ~= q * scale + zero   with q unsigned ints in [0, 2^r_in - 1]."""
    q: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor


def quantize_act(x: torch.Tensor, r_in: int, *,
                 segment_ids: Optional[torch.Tensor] = None,
                 eps: float = 1e-8) -> ActQuant:
    """Unsigned asymmetric activation quantization with a tensor-global
    dynamic swing (scale/zero from the tensor's own min/max).

    `segment_ids` (per-segment statistics) belongs to request isolation,
    which this port does not carry yet: passing it raises."""
    if segment_ids is not None:
        raise NotImplementedError(
            "segment-wise activation quantization is not ported yet")
    levels = 2.0 ** r_in - 1.0
    zero = torch.min(x)
    scale = torch.clamp_min(torch.max(x) - zero, eps) \
        * _static_reciprocal(levels)
    q = torch.round(torch.clamp((x - zero) / scale, 0.0, levels))
    return ActQuant(q=q, scale=scale, zero=zero)


class WeightQuant(NamedTuple):
    """w ~= q * scale, q odd ints in +/-(2^r_w - 1)  (per-out-channel scale)."""
    q: torch.Tensor
    scale: torch.Tensor


def quantize_weight(w: torch.Tensor, r_w: int, *, axis: int = 0,
                    eps: float = 1e-8) -> WeightQuant:
    """Quantize to the macro's odd-integer grid (bit-planes of +/-1 signs).

    The representable values are the 2^r_w odd integers in
    [-(2^r_w - 1), 2^r_w - 1]; step 2.  Scale is per-output-channel
    (reduction over `axis`).
    """
    full = 2.0 ** r_w - 1.0
    amax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, eps) * _static_reciprocal(full)
    u = torch.clamp(w / scale, -full, full)
    # nearest odd integer: 2*round((u-1)/2)+1 (the divide by 2 is exact)
    q = 2.0 * torch.round((u - 1.0) * 0.5) + 1.0
    q = torch.clamp(q, -full, full)
    return WeightQuant(q=q, scale=scale)

"""Straight-through-estimator quantizers of the CIM datapath.

Counterpart of `repro/core/quantization.py`: activations are quantized to
r_in unsigned bits with an *adaptive swing* (the dynamic scale plays the
role of the serial-split DPL configuration + signed-to-unsigned
conversion), weights to the macro's odd-integer +/-1 bit-plane grid, and
outputs to r_out ADC codes through the ABN-scaled floor of Eq. (7).

The float chain is held bit for bit to the JAX package: scales multiply by
the f32-rounded reciprocal of the level count (`_static_reciprocal`), the
activation divide `(x - zero) / scale` is an IEEE divide whose divisor is a
tensor on the operand's device, and rounding is half-to-even
(`torch.round`, like `jnp.round`).  Eager PyTorch runs each operator as its
own kernel and never fuses or contracts them, so the JAX package's
`rounding_barrier` is the identity here; it stays at every place the
JAX package puts it, and under a cimcheck trace it leaves the marker the
barrier lint stops at (`repro_torch.analysis.barriers`).

Gradients follow the JAX package's: rounding and flooring pass the
gradient straight through (`ste`), swing and weight scales are constants
(computed from detached tensors), and every clip is `_clip`, whose
gradient is 1/2 at either bound, as `jnp.clip`'s (`torch.clamp`'s is 1).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch


def ste(fwd: torch.Tensor, grad_of: torch.Tensor) -> torch.Tensor:
    """Forward `fwd`, but gradient flows as if it were `grad_of`."""
    return grad_of + (fwd - grad_of).detach()


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return ste(torch.round(x), x)


def ste_floor(x: torch.Tensor) -> torch.Tensor:
    return ste(torch.floor(x), x)


# the recorder of a cimcheck trace while one runs, else None
# (analysis.graph_walk.trace)
_LINT_TRACE = None


def rounding_barrier(x: torch.Tensor) -> torch.Tensor:
    """The identity: eager PyTorch never fuses or contracts the float ops
    around it (see the module docstring).  Under a cimcheck trace it
    returns `aten.alias(x)`, a node the trace keeps and the barrier lint
    stops at; eagerly it costs one branch and no operator."""
    if _LINT_TRACE is not None:
        return torch.ops.aten.alias(x)
    return x


def lint_opaque(fn=None, *, record: bool = True):
    """Mark `fn` as one fresh value to cimcheck, as the JAX package's
    jaxpr holds a transcendental or a draw as one primitive.  Under a lint
    trace the nodes its call records are tagged ``cimcheck_opaque``, and
    the barrier lint neither starts at a rounding op among them nor walks
    into them (the port's copies of XLA's routines fuse by design); with
    ``record=False`` the call is not recorded and its result enters the
    graph as a constant (for a draw: thousands of integer ops that no
    float contract reads).  Eagerly the call passes straight through."""
    if fn is None:
        return functools.partial(lint_opaque, record=record)

    @functools.wraps(fn)
    def opaque(*args, **kwargs):
        if _LINT_TRACE is None:
            return fn(*args, **kwargs)
        with _LINT_TRACE.opaque(record):
            return fn(*args, **kwargs)
    return opaque


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """jnp.clip with its gradient: min(max(x, lo), hi) with tensor bounds,
    whose gradient is 1/2 where x equals a bound (torch.clamp gives 1)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


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
                 scale: Optional[torch.Tensor] = None,
                 zero: Optional[torch.Tensor] = None,
                 segment_ids: Optional[torch.Tensor] = None,
                 num_segments: Optional[int] = None,
                 eps: float = 1e-8) -> ActQuant:
    """Unsigned asymmetric activation quantization (the datapath's
    signed-to-unsigned conversion + adaptive input swing).

    A given `scale` or `zero` (a tensor or a float) is used as it is, and
    the gradient flows into it as into any operand.  One left None is
    computed from the tensor's own min/max (the dynamic swing), a
    constant to the gradient; the STE flows through the rounding only.

    `segment_ids` (optional, shape (x.shape[0],) int, values in
    [0, num_segments)) switches the dynamic min/max from tensor-global to
    *per-segment* over the leading axis: rows sharing an id share one
    swing, rows of different segments never see each other's statistics.
    Min and max are exact, so a row's segment statistics equal its solo
    statistics bit for bit, whatever its batchmates.  The dynamic
    scale/zero then broadcast per row, shape (x.shape[0], 1, ...).
    `num_segments` defaults to x.shape[0]."""
    levels = 2.0 ** r_in - 1.0
    inv_levels = _static_reciprocal(levels)
    if scale is not None:
        scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    if zero is not None:
        zero = torch.as_tensor(zero, dtype=x.dtype, device=x.device)
    xd = x.detach()
    if segment_ids is not None and (zero is None or scale is None):
        n_seg = x.shape[0] if num_segments is None else num_segments
        ids = segment_ids.to(device=x.device, dtype=torch.int64).reshape(-1)
        rows = xd.reshape(x.shape[0], -1)
        # per-row extrema, then per-segment extrema gathered back per row
        seg_max = torch.full((n_seg,), float("-inf"), dtype=x.dtype,
                             device=x.device).scatter_reduce(
            0, ids, torch.amax(rows, dim=1), "amax")
        seg_min = torch.full((n_seg,), float("inf"), dtype=x.dtype,
                             device=x.device).scatter_reduce(
            0, ids, torch.amin(rows, dim=1), "amin")
        bshape = (x.shape[0],) + (1,) * (x.dim() - 1)
        if zero is None:
            zero = seg_min[ids].reshape(bshape)
        if scale is None:
            scale = torch.clamp_min(seg_max[ids].reshape(bshape)
                                    - zero.detach(), eps) * inv_levels
    if zero is None:
        zero = torch.min(xd)
    if scale is None:
        scale = torch.clamp_min(torch.max(xd) - zero.detach(), eps) \
            * inv_levels
    q = ste_round(_clip((x - zero) / scale, 0.0, levels))
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
    amax = torch.amax(torch.abs(w.detach()), dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, eps) * _static_reciprocal(full)
    u = _clip(w / scale, -full, full)
    # nearest odd integer with STE: 2*round((u-1)/2)+1 (the divide by 2 is
    # exact)
    q = 2.0 * ste_round((u - 1.0) * 0.5) + 1.0
    q = _clip(q, -full, full)
    return WeightQuant(q=q, scale=scale)


def adc_quantize(dp: torch.Tensor, *, r_out: int, gain: torch.Tensor,
                 beta_codes: torch.Tensor) -> torch.Tensor:
    """Eq. (7) in code space with STE: code = floor(mid + gain*dp + beta),
    clipped to [0, 2^r_out - 1], plus 0.5 (the code's centre)."""
    mid = 2.0 ** (r_out - 1)
    code = ste_floor(mid + rounding_barrier(gain * dp) + beta_codes)
    return _clip(code, 0.0, 2.0 ** r_out - 1.0) + 0.5

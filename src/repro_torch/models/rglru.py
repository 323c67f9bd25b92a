"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

Counterpart of `repro/models/rglru.py`.  The Real-Gated Linear Recurrent
Unit:

    r_t = sigmoid(W_a x_t + b_a)            (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)            (input gate)
    log a_t = -c * softplus(Lambda) * r_t   (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The block follows Griffin: (GeLU branch) * (conv1d -> RG-LRU branch),
then the output projection; the three projections run through
`core.cim_layers.cim_linear_apply`, the gate products w_a / w_x are
plain float32 matmuls (outside the macro, as in JAX) pinned against
TF32 (`cim_layers.exact_float32_matmul`).

`rglru_scan` evaluates the linear recurrence in log2(L) levels, as
`jax.lax.associative_scan` does, with its recursion (pairs combined,
scanned, the even positions filled in), so each h_t is the same sums and
products associated as in JAX, and each `b_l * a_r + b_r` is rounded once,
as XLA's CPU code fuses it (`core.xla_f32.fma_f32`): the port's scan
equals jitted JAX's bit for bit (`tests/test_torch_recurrent.py`, L up to
4096).  The rounding matters beyond the ulps: in fakequant an ulp can
move an activation code of the next projection.

With a state, a call of L == 1 token is JAX's O(1) decode update; a call
of L > 1 tokens (a cached prefill) runs `rglru_scan(a, b, h0=state["h"])`
and keeps h[:, -1].  JAX's own state branch applies the one-step update
to every token (`a_t * h0 + b_t`), which is not the recurrence; the port
does not copy that (ROADMAP Queue 3, reference fault 11).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.cim_layers import (CIMConfig, cim_linear_apply,
                                         exact_float32_matmul,
                                         init_cim_linear)
from repro_torch.core.xla_f32 import fma_f32
from repro_torch.models.sharding import BATCH, TP, shard

_C = 8.0


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    with no threshold (F.softplus returns x itself above 20)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def init_rglru_block(generator: torch.Generator, d_model: int, width: int,
                     conv_width: int = 4,
                     cim: Optional[CIMConfig] = None) -> Dict:
    """One block's parameters on the generator's device, JAX's tree: the
    three CIM projections, the depthwise conv (conv_width, width), the
    gate products w_a / w_x (width, width) with their biases, and Lambda
    set so that a lies in [0.9, 0.999] at r = 1 (Griffin's appendix)."""
    dev = generator.device
    sw = (1.0 / width) ** 0.5

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=dev)
    lam = torch.linspace(0.9, 0.999, width, device=dev)
    return {
        "w_gelu": init_cim_linear(generator, d_model, width, cfg=cim),
        "w_rnn": init_cim_linear(generator, d_model, width, cfg=cim),
        "conv_w": 0.1 * normal(conv_width, width),
        "conv_b": torch.zeros((width,), device=dev),
        "w_a": sw * normal(width, width),
        "b_a": torch.zeros((width,), device=dev),
        "w_x": sw * normal(width, width),
        "b_x": torch.zeros((width,), device=dev),
        "lam": torch.log(torch.expm1(-torch.log(lam) / _C)),
        "w_out": init_cim_linear(generator, width, d_model, cfg=cim),
    }


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once, as XLA's CPU code computes it (LLVM fuses
    the product into the sum); its gradient is that of a * b + c."""
    r = a * b + c
    return r + (fma_f32(a.detach(), b.detach(), c.detach()) - r).detach()


def _combine(al, bl, ar, br):
    """The scan's operator: the step (al, bl) then (ar, br)."""
    return al * ar, _fma(bl, ar, br)


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], odd[1], ... along axis 1 (even may hold
    one more)."""
    n = odd.shape[1]
    out = torch.stack([even[:, :n], odd], dim=2).flatten(1, 2)
    return torch.cat([out, even[:, n:]], dim=1)


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """jax.lax.associative_scan's recursion along axis 1: combine the
    pairs, scan them, then fill in the even positions; so each element is
    the same product and sum, associated as JAX associates it."""
    n = a.shape[1]
    if n < 2:
        return a, b
    ra, rb = _combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = _associative_scan(ra, rb)
    if n % 2 == 0:
        ea, eb = _combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = _combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 (h_{-1} = h0, or 0): a, b
    (B, L, W) -> h (B, L, W), in log2(L) levels of JAX's associative
    scan (out of place, so autograd runs through it)."""
    if h0 is not None:
        b = torch.cat([_fma(a[:, :1], h0[:, None], b[:, :1]), b[:, 1:]],
                      dim=1)
    return _associative_scan(a, b)[1]


def rglru_block(params: Dict, x: torch.Tensor, cim: CIMConfig, *,
                state: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, L, D) -> (out (B, L, D) in x's dtype, new_state).  state =
    {"h": (B, W) float32, "conv": (B, conv_width - 1, W)} carries the
    recurrence and the conv's last inputs; new_state is None without
    one, else {"h": h[:, -1], "conv": the last conv_width - 1 inputs in
    the projections' dtype}."""
    gelu_branch = F.gelu(cim_linear_apply(params["w_gelu"], x, cim),
                         approximate="tanh")
    gelu_branch = shard(gelu_branch, BATCH, None, TP)
    u = cim_linear_apply(params["w_rnn"], x, cim)
    u = shard(u, BATCH, None, TP)

    width = params["conv_w"].shape[0]
    length = u.shape[1]
    if state is None:
        up = F.pad(u, (0, 0, width - 1, 0))
        new_conv = None
    else:
        up = torch.cat([state["conv"].to(u.dtype), u], dim=1)
        new_conv = up[:, -(width - 1):, :]
    uc = sum(up[:, i:i + length, :] * params["conv_w"][i]
             for i in range(width))
    uc = uc + params["conv_b"]

    ucf = uc.to(torch.float32)
    with exact_float32_matmul():
        r = torch.sigmoid(ucf @ params["w_a"] + params["b_a"])
        i = torch.sigmoid(ucf @ params["w_x"] + params["b_x"])
    log_a = -_C * softplus(params["lam"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * ucf)

    if state is None:
        h = rglru_scan(a, b)
        new_state = None
    else:
        if length == 1:
            h = _fma(a, state["h"][:, None, :], b)     # O(1) decode step
        else:
            h = rglru_scan(a, b, h0=state["h"])
        new_state = {"h": h[:, -1, :], "conv": new_conv}

    y = gelu_branch.to(torch.float32) * h
    out = cim_linear_apply(params["w_out"], y.to(x.dtype), cim)
    return shard(out, BATCH, None, None), new_state


def init_rglru_state(batch: int, width: int, conv_width: int = 4,
                     device=None) -> Dict:
    """A zeroed decode state: "h" (batch, width) float32 and "conv"
    (batch, conv_width - 1, width) bfloat16, JAX's dtypes."""
    return {"h": torch.zeros((batch, width), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, conv_width - 1, width),
                                dtype=torch.bfloat16, device=device)}

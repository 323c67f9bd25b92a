"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060).

Counterpart of `repro/models/mamba2.py`.  Training and a cache-free
forward use the chunked SSD algorithm (quadratic within a chunk, linear
across chunks through a state recurrence, a loop over the chunks where
JAX runs `lax.scan`); decode is the O(1)-per-token state update.  The in
and out projections run through `core.cim_layers.cim_linear_apply` like
every other GEMM; the SSD products are plain float32 einsums outside the
macro, as in JAX, pinned against TF32 (`cim_layers.exact_float32_matmul`).
`softplus` is JAX's form (`rglru.softplus`), without F.softplus's
threshold.

With a state, a call of L == 1 token is JAX's O(1) decode update; a call
of L > 1 tokens (a cached prefill) runs `ssd_chunked(...,
init_state=state["ssm"])` and keeps its final state.  JAX's own state
branch updates the state from token 0 alone whatever L is; the port does
not copy that (ROADMAP Queue 3, reference fault 11).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.cim_layers import (CIMConfig, cim_linear_apply,
                                         exact_float32_matmul,
                                         init_cim_linear)
from repro_torch.models.common import activation_fn
from repro_torch.models.rglru import softplus
from repro_torch.models.sharding import BATCH, TP, shard


def ssm_dims(d_model: int, expand: int, headdim: int, d_state: int,
             n_groups: int = 1):
    """(d_inner, n_heads, conv channels, in_proj's fan-out)."""
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_ch = d_inner + 2 * n_groups * d_state
    proj_out = 2 * d_inner + 2 * n_groups * d_state + n_heads
    return d_inner, n_heads, conv_ch, proj_out


def init_mamba2_layer(generator: torch.Generator, d_model: int, *,
                      expand: int, headdim: int, d_state: int,
                      conv_width: int, cim: Optional[CIMConfig] = None,
                      n_groups: int = 1) -> Dict:
    """One layer's parameters on the generator's device, JAX's tree."""
    d_inner, n_heads, conv_ch, proj_out = ssm_dims(
        d_model, expand, headdim, d_state, n_groups)
    dev = generator.device
    return {
        "in_proj": init_cim_linear(generator, d_model, proj_out, cfg=cim),
        "conv_w": 0.1 * torch.randn((conv_width, conv_ch),
                                    generator=generator, device=dev),
        "conv_b": torch.zeros((conv_ch,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev)),
        "D_skip": torch.ones((n_heads,), device=dev),
        "dt_bias": torch.zeros((n_heads,), device=dev),
        "gate_norm": torch.ones((d_inner,), device=dev),
        "out_proj": init_cim_linear(generator, d_inner, d_model, cfg=cim),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv then SiLU.  x (B, L, C), w (W, C).  Returns
    (y, new_state), the state carrying the trailing W - 1 inputs."""
    width = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(width))
    return activation_fn("silu")(y + b), xp[:, -(width - 1):, :]


def _segsum(da: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise sums: out[..., i, j] = sum_{j<t<=i}
    da[t], -inf above the diagonal."""
    q = da.shape[-1]
    cs = torch.cumsum(da, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                 device=da.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, *, chunk: int,
                init_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD.  xh (B, L, H, P), dt (B, L, H), a (H,) negative, B/C
    (B, L, G, N) with G dividing H.  Returns (y (B, L, H, P), final state
    (B, H, P, N)); `init_state` (B, H, P, N) is the state before token
    0 (zero without one)."""
    bsz, length, h, p = xh.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = (-length) % chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (length + pad) // chunk
    xc = xh.reshape(bsz, nc, chunk, h, p)
    dtc = dt.reshape(bsz, nc, chunk, h)
    Bc = torch.repeat_interleave(B.reshape(bsz, nc, chunk, g, n), rep, dim=3)
    Cc = torch.repeat_interleave(C.reshape(bsz, nc, chunk, g, n), rep, dim=3)

    da = torch.movedim(dtc * a, -1, 2)                  # (B, nc, H, Q)
    decay = torch.exp(_segsum(da))                      # (B, nc, H, Q, Q)
    with exact_float32_matmul():
        # intra-chunk (diagonal blocks)
        scores = torch.einsum("bcqhn,bckhn->bchqk", Cc, Bc) * decay
        scores = scores * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
        y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xc)

        # chunk-final states
        cum = torch.cumsum(da, dim=-1)                  # (B, nc, H, Q)
        decay_to_end = torch.exp(cum[..., -1:] - cum)
        su = Bc * (dtc * torch.movedim(decay_to_end, 2, -1))[..., None]
        states = torch.einsum("bcqhn,bcqhp->bchpn", su, xc)

        # inter-chunk recurrence, emitting the state before each chunk
        chunk_decay = torch.exp(cum[..., -1])           # (B, nc, H)
        carry = (torch.zeros((bsz, h, p, n), dtype=xh.dtype,
                             device=xh.device)
                 if init_state is None else init_state)
        prev = []
        for c in range(nc):
            prev.append(carry)
            carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
        prev_states = torch.stack(prev, dim=1)          # (B, nc, H, P, N)

        # off-diagonal contribution: decay from the chunk's start
        in_decay = torch.exp(cum)
        y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                             Cc * torch.movedim(in_decay, 2, -1)[..., None],
                             prev_states)
    y = (y_diag + y_off).reshape(bsz, length + pad, h, p)[:, :length]
    return y, carry


def ssd_naive(xh, dt, a, B, C, init_state=None):
    """The O(L) recurrence, token by token (the oracle of the tests)."""
    bsz, length, h, p = xh.shape
    g, n = B.shape[2], B.shape[3]
    Br = torch.repeat_interleave(B, h // g, dim=2)
    Cr = torch.repeat_interleave(C, h // g, dim=2)
    s = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=xh.device)
         if init_state is None else init_state.to(torch.float32))
    ys = []
    with exact_float32_matmul():
        for t in range(length):
            dec = torch.exp(dt[:, t] * a[None, :])
            s = s * dec[..., None, None] + torch.einsum(
                "bh,bhn,bhp->bhpn", dt[:, t], Br[:, t], xh[:, t])
            ys.append(torch.einsum("bhn,bhpn->bhp", Cr[:, t], s))
    return torch.stack(ys, dim=1), s


def mamba2_layer(params: Dict, x: torch.Tensor, cfg, cim: CIMConfig, *,
                 state: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """One Mamba-2 mixer.  x (B, L, D) -> (out (B, L, D) in x's dtype,
    new_state).  state = {"ssm": (B, H, P, N) float32, "conv": (B, W - 1,
    C)}; new_state is None without one."""
    bsz, length, d_model = x.shape
    d_inner, n_heads, conv_ch, _ = ssm_dims(
        d_model, cfg.ssm_expand, cfg.ssm_headdim, cfg.ssm_state)
    g, n, p = 1, cfg.ssm_state, cfg.ssm_headdim

    zxbcdt = cim_linear_apply(params["in_proj"], x, cim)
    zxbcdt = shard(zxbcdt, BATCH, None, TP)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, conv_ch, n_heads], dim=-1)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 None if state is None else state["conv"])
    xc, B, C = torch.split(xbc, [d_inner, g * n, g * n], dim=-1)
    xh = shard(xc.reshape(bsz, length, n_heads, p), BATCH, None, TP, None)
    B = B.reshape(bsz, length, g, n)
    C = C.reshape(bsz, length, g, n)
    dt = softplus(dt.to(torch.float32) + params["dt_bias"])
    a = -torch.exp(params["A_log"])

    f32 = torch.float32
    if state is None or length > 1:
        y, final = ssd_chunked(
            xh.to(f32), dt, a, B.to(f32), C.to(f32), chunk=cfg.ssm_chunk,
            init_state=None if state is None else state["ssm"])
    else:
        # decode: the single-step state update
        s = state["ssm"]
        dec = torch.exp(dt[:, 0] * a[None, :])
        Br = torch.repeat_interleave(B[:, 0], n_heads // g, dim=1)
        Cr = torch.repeat_interleave(C[:, 0], n_heads // g, dim=1)
        with exact_float32_matmul():
            s = s * dec[..., None, None] + torch.einsum(
                "bh,bhn,bhp->bhpn", dt[:, 0], Br.to(f32), xh[:, 0].to(f32))
            y = torch.einsum("bhn,bhpn->bhp", Cr.to(f32), s)[:, None]
        final = s
    new_state = None if state is None else {"ssm": final, "conv": new_conv}
    y = y + xh.to(f32) * params["D_skip"][None, None, :, None]
    y = y.reshape(bsz, length, d_inner)

    # gated RMSNorm, then the out-projection
    gated = y * activation_fn("silu")(z.to(f32))
    gn = gated * torch.rsqrt(torch.mean(gated * gated, -1, keepdim=True)
                             + 1e-6) * params["gate_norm"]
    out = cim_linear_apply(params["out_proj"], gn.to(x.dtype), cim)
    return shard(out, BATCH, None, None), new_state


def init_mamba2_state(batch: int, d_model: int, cfg, dtype=torch.float32,
                      device=None) -> Dict:
    """A zeroed decode state: "ssm" (batch, H, P, N) float32 and "conv"
    (batch, conv_width - 1, conv channels) of `dtype` (float32, JAX's
    default)."""
    _, n_heads, conv_ch, _ = ssm_dims(
        d_model, cfg.ssm_expand, cfg.ssm_headdim, cfg.ssm_state)
    return {"ssm": torch.zeros((batch, n_heads, cfg.ssm_headdim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                                dtype=dtype, device=device)}

"""OLMo-1B's decoder (arXiv:2402.00838) with engine-mode projections,
written plainly: a full forward over one request's tokens, no cache.

Embedding, non-parametric LayerNorm (eps 1e-6), RoPE (theta 1e4, halves
rotated), causal multi-head attention, SwiGLU, the tied head.  Every
projection runs through the macro (`cim.projection`) at (r_in, r_w).
Served in flight, each request is quantized as it was served: its prompt
(one prefill) on one swing, and each generated token on its own.

The model's compute type is bfloat16; `act` is the type every stored
activation is rounded to (bfloat16, or a lower one for the control),
while norms, RoPE, softmax and the head run in float32 as the program
runs them.
"""
from __future__ import annotations

from typing import Dict

import torch

from bench.reference import cim


def _rnd(x: torch.Tensor, act) -> torch.Tensor:
    return x.to(act).to(torch.float32)


def _norm(x: torch.Tensor) -> torch.Tensor:
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-6)


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D) at positions (T,)."""
    d = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                        device=x.device) / d))
    ang = pos[:, None].to(torch.float32) * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


@torch.no_grad()
def logits(cfg: Dict, params: Dict, tokens: torch.Tensor, prompt_len: int,
           *, act=torch.bfloat16) -> torch.Tensor:
    """Float32 logits (T, V) at every position of `tokens` (T,), whose
    first `prompt_len` were the prompt."""
    t = tokens.shape[0]
    dev = tokens.device
    h_n, hd = cfg["num_attention_heads"], cfg["head_dim"]
    seg = torch.arange(t, device=dev) - (prompt_len - 1)
    seg = torch.clamp_min(seg, 0)
    pos = torch.arange(t, device=dev)

    def proj(p, x):
        return _rnd(cim.projection(
            x, p["w"], p["abn_log_gamma"], p["abn_beta"],
            r_in=cfg["r_in"], r_w=cfg["r_w"], max_gamma=cfg["max_gamma"],
            segments=seg), act)

    x = _rnd(params["embed"][tokens], act)
    keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))
    for lp in params["layers"]:
        a = lp["attn"]
        h = _rnd(_norm(x), act)
        q = proj(a["wq"], h).reshape(t, h_n, hd)
        k = proj(a["wk"], h).reshape(t, h_n, hd)
        v = proj(a["wv"], h).reshape(t, h_n, hd)
        q = _rnd(_rope(q, pos, cfg["rope_theta"]), act)
        k = _rnd(_rope(k, pos, cfg["rope_theta"]), act)
        s = torch.einsum("qhd,khd->hqk", q / hd ** 0.5, k)
        s = torch.where(keep, s, float("-inf"))
        o = _rnd(torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v), act)
        x = _rnd(x + proj(a["wo"], o.reshape(t, h_n * hd)), act)
        m = lp["mlp"]
        h = _rnd(_norm(x), act)
        up = proj(m["w_up"], h)
        gate = proj(m["w_gate"], h)
        # silu as the program rounds it: 1 / (1 + exp(-g)), then g * s
        sg = _rnd(1.0 / _rnd(1.0 + _rnd(torch.exp(-gate), act), act), act)
        hidden = _rnd(_rnd(gate * sg, act) * up, act)
        x = _rnd(x + proj(m["w_down"], hidden), act)
    x = _rnd(_norm(x), act)
    return x @ _rnd(params["embed"], act).T


def served_gap(ref_logits: torch.Tensor, served, prompt_len: int) -> float:
    """The widest gap by which a served token's reference logit lies
    below the reference's best at its position: token i of `served` was
    chosen at position prompt_len - 1 + i."""
    rows = ref_logits[prompt_len - 1: prompt_len - 1 + len(served)]
    tok = torch.as_tensor(list(served), device=rows.device)
    best = torch.amax(rows, dim=-1)
    got = rows[torch.arange(len(served), device=rows.device), tok]
    return float(torch.max(best - got))


def greedy(logits_: torch.Tensor, prompt_len: int, n: int) -> list:
    """The tokens that `logits_` puts first at the n positions whose
    choices are served: prompt_len - 1 onwards."""
    rows = logits_[prompt_len - 1: prompt_len - 1 + n]
    return torch.argmax(rows, -1).tolist()

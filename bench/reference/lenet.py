"""LeNet-5 of the IMAGINE paper through the macro, written plainly.

conv 3x3x16 (pad 1) -> relu -> 2x2 max-pool -> conv 3x3x32 (pad 1) ->
relu -> 2x2 max-pool -> flatten (h, w, c) -> fc 1568->128 -> relu ->
fc 128->10, every product an engine-mode projection (`cim.projection`)
over the whole batch's swing.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch

from bench.reference import cim

def patches(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B*H*W, 9*C): 3x3 patches, stride 1, zero padding
    1, features in (kh, kw, c) order."""
    b, h, w, c = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, i:i + h, j:j + w, :] for i in range(3) for j in range(3)]
    return torch.stack(cols, dim=3).reshape(b * h * w, 9 * c)


def pool2(y: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool, stride 2, over (B, H, W, C)."""
    b, h, w, c = y.shape
    return torch.amax(y.reshape(b, h // 2, 2, w // 2, 2, c), dim=(2, 4))


def forward(params: Dict[str, Dict[str, torch.Tensor]], images: torch.Tensor,
            *, r_in: int, r_w: int, max_gamma: float,
            dt=torch.float32) -> torch.Tensor:
    """Logits (B, 10) of images (B, 28, 28, 1), computed in `dt` outside
    the integer products."""

    def proj(name, rows):
        p = params[name]
        return cim.projection(rows, p["w"], p["abn_log_gamma"],
                              p["abn_beta"], r_in=r_in, r_w=r_w,
                              max_gamma=max_gamma, dt=dt)
    h = images.to(dt)
    for name in ("conv1", "conv2"):
        b, hh, ww, _ = h.shape
        y = torch.relu(proj(name, patches(h)))
        h = pool2(y.reshape(b, hh, ww, -1))
    h = torch.relu(proj("fc1", h.reshape(h.shape[0], -1)))
    return proj("fc2", h).to(torch.float32)


def logit_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |got - ref| over a batch's logits, as a share of the
    reference's largest |logit|."""
    got = got.to(ref.device, torch.float32)
    return float(torch.max(torch.abs(got - ref))
                 / torch.clamp_min(torch.max(torch.abs(ref)), 1e-30))


def layer_shapes(batch: int) -> Sequence[tuple]:
    """(M, K, N) of the four products at a batch."""
    return ((batch * 784, 9, 16), (batch * 196, 144, 32),
            (batch, 1568, 128), (batch, 128, 10))

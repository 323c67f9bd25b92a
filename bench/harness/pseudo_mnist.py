"""Procedural pseudo-MNIST, rendered with numpy: the benchmark's frozen copy
of the port's generator (`repro_torch/data/pseudo_mnist.py`; same seed,
same images).  Ten stroke-template digit classes at 28x28 with random
affine jitter, stroke-thickness variation and pixel noise.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# 7-segment-like templates on a 4x7 grid of strokes, per digit
_SEGS = {
    #        top  tl   tr   mid  bl   br   bot  diag
    0: (1, 1, 1, 0, 1, 1, 1, 0),
    1: (0, 0, 1, 0, 0, 1, 0, 0),
    2: (1, 0, 1, 1, 1, 0, 1, 0),
    3: (1, 0, 1, 1, 0, 1, 1, 0),
    4: (0, 1, 1, 1, 0, 1, 0, 0),
    5: (1, 1, 0, 1, 0, 1, 1, 0),
    6: (1, 1, 0, 1, 1, 1, 1, 0),
    7: (1, 0, 1, 0, 0, 1, 0, 1),
    8: (1, 1, 1, 1, 1, 1, 1, 0),
    9: (1, 1, 1, 1, 0, 1, 1, 0),
}


def render(digit: int, rng: np.random.Generator) -> np.ndarray:
    img = np.zeros((28, 28), np.float32)
    x0, x1 = 7, 20
    y0, ym, y1 = 5, 14, 23
    th = rng.integers(1, 3)

    def hline(y, xa, xb):
        img[max(y - th, 0):y + th, xa:xb] = 1.0

    def vline(x, ya, yb):
        img[ya:yb, max(x - th, 0):x + th] = 1.0

    top, tl, tr, mid, bl, br, bot, diag = _SEGS[digit]
    if top:
        hline(y0, x0, x1)
    if mid:
        hline(ym, x0, x1)
    if bot:
        hline(y1, x0, x1)
    if tl:
        vline(x0, y0, ym)
    if tr:
        vline(x1, y0, ym)
    if bl:
        vline(x0, ym, y1)
    if br:
        vline(x1, ym, y1)
    if diag:
        for i in range(y0, y1):
            x = int(x1 - (x1 - x0) * (i - y0) / (y1 - y0))
            img[i, max(x - th, 0):x + th] = 1.0

    # random affine jitter: shift + slight scale
    sx, sy = rng.integers(-3, 4, 2)
    img = np.roll(np.roll(img, sy, axis=0), sx, axis=1)
    img += rng.normal(0.0, 0.15, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def make_dataset(n_train: int = 8000, n_test: int = 2000, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    def gen(n):
        ys = rng.integers(0, 10, n)
        xs = np.stack([render(int(y), rng) for y in ys])
        return xs.astype(np.float32), ys.astype(np.int32)
    xtr, ytr = gen(n_train)
    xte, yte = gen(n_test)
    return xtr, ytr, xte, yte

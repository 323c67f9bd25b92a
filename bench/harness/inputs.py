"""What the benchmark makes from the seed and hands to both the program
and the reference: weights, images and token ids.

Weights are drawn on the device with a `torch.Generator`, one call a
tensor, in float32 (the type the engine binds them in): w ~ N(0, 1/K),
the ABN gain log2(gamma) set by the distribution-aware rule of the
paper's analytic init, the ABN offset zero.  Images are procedural
pseudo-MNIST (`pseudo_mnist.py`), rendered on the host with numpy.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from bench.reference import cim

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on `device` for the seed's stream `stream`."""
    return torch.Generator(device=device).manual_seed(
        (int(seed) * 1000003 + stream) & SEED_MASK)


def analytic_log_gamma(k: int, r_in: int, r_w: int, r_out: int,
                       max_gamma: float, target_frac: float = 0.25) -> float:
    """log2(gamma) that scales the expected dp spread of one row tile to
    `target_frac` of the ADC half-range, for amax-scaled normal
    activations and weights (codes of std ~2^r_in/8 and ~2^(r_w-1)/2),
    clipped to [1, max_gamma]."""
    k_tile = cim.row_tiles(k)[0][1]
    g0 = cim.unity_gain(k, r_in, r_w, r_out)
    sigma_dp = (k_tile ** 0.5) * (2.0 ** r_in / 8.0) * (2.0 ** (r_w - 1)
                                                         / 2.0)
    gamma = target_frac * 2.0 ** (r_out - 1) / (g0 * sigma_dp)
    return math.log2(min(max(gamma, 1.0), float(max_gamma)))


def cim_linear(gen: torch.Generator, k: int, n: int, cfg: Dict,
               device) -> Dict[str, torch.Tensor]:
    """One projection's raw parameters: w (K, N), abn_log_gamma (N,),
    abn_beta (N,), all float32."""
    w = torch.randn((k, n), generator=gen, dtype=torch.float32,
                    device=device) * (1.0 / k) ** 0.5
    lg = analytic_log_gamma(k, cfg["r_in"], cfg["r_w"], cfg.get("r_out", 8),
                            cfg["max_gamma"])
    return {"w": w,
            "abn_log_gamma": torch.full((n,), lg, dtype=torch.float32,
                                        device=device),
            "abn_beta": torch.zeros((n,), dtype=torch.float32,
                                    device=device)}


def lenet_weights(cfg: Dict, seed: int, device) -> Dict[str, Dict]:
    """{layer: params} of the configuration's layers, in its order."""
    gen = generator(seed, device, 1)
    return {name: cim_linear(gen, k, n, cfg, device)
            for name, k, n in cfg["layers"]}


def olmo_weights(cfg: Dict, seed: int, device) -> Dict:
    """The dense decoder's tree as the port's transformer takes it:
    embed (V, d) ~ N(0, 1/d), per layer attn {wq, wk, wv, wo} and mlp
    {w_up, w_gate, w_down}, parameter-free norms."""
    gen = generator(seed, device, 2)
    d, f, v = (cfg["hidden_size"], cfg["intermediate_size"],
               cfg["vocab_size"])
    hd = cfg["head_dim"] * cfg["num_attention_heads"]
    embed = torch.randn((v, d), generator=gen, dtype=torch.float32,
                        device=device) * d ** -0.5
    layers: List[Dict] = []
    for _ in range(cfg["num_hidden_layers"]):
        attn = {name: cim_linear(gen, d, hd, cfg, device)
                for name in ("wq", "wk", "wv")}
        attn["wo"] = cim_linear(gen, hd, d, cfg, device)
        mlp = {"w_up": cim_linear(gen, d, f, cfg, device),
               "w_down": cim_linear(gen, f, d, cfg, device),
               "w_gate": cim_linear(gen, d, f, cfg, device)}
        layers.append({"ln1": {}, "ln2": {}, "attn": attn, "mlp": mlp})
    return {"embed": embed, "final_norm": {}, "layers": layers}


def images(n: int, seed: int, device) -> torch.Tensor:
    """(n, 28, 28, 1) float32 pseudo-MNIST on `device`."""
    from bench.harness.pseudo_mnist import render
    rng = np.random.default_rng(int(seed) & SEED_MASK)
    ys = rng.integers(0, 10, n)
    xs = np.stack([render(int(y), rng) for y in ys])
    return torch.from_numpy(xs)[..., None].to(device)

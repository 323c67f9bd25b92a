"""Parameters of the JAX package, as numpy arrays, into the port's tensors.

The layouts match, so nothing is transposed: each CIM layer is
{"w": (K, N) with K in (kh, kw, c_in) order for a conv, "abn_log_gamma":
(N,), "abn_beta": (N,)}.  `params_from_numpy` converts layer params;
`decode_lm_from_numpy` builds a whole in-flight decode model from the fp32
masters of its projections, so both packages can serve the same weights.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

LAYER_KEYS = ("w", "abn_log_gamma", "abn_beta")

Layer = Mapping[str, object]


def _layer(p: Layer, device) -> Dict[str, torch.Tensor]:
    missing = [k for k in LAYER_KEYS if k not in p]
    if missing:
        raise ValueError(f"layer params lack {missing}")
    return {k: torch.from_numpy(np.array(p[k], dtype=np.float32)).to(device)
            for k in LAYER_KEYS}


def params_from_numpy(params: Union[Mapping[str, Layer], Sequence[Layer]],
                      device="cpu") -> Union[Dict[str, Dict], List[Dict]]:
    """float32 tensors on `device` from array-like layer params.

    `params` is a name-keyed dict of layers (as `init_lenet` returns) or a
    positional list of them (as `lenet_params_list` returns); the result
    has the same shape.  Arrays are copied, never shared."""
    if isinstance(params, Mapping):
        return {name: _layer(p, device) for name, p in params.items()}
    return [_layer(p, device) for p in params]


BLOCK_KEYS = ("q", "k", "v", "o", "gate", "up", "down")


def decode_lm_from_numpy(embed, blocks: Sequence[Mapping[str, Layer]], *,
                         n_heads: int, window: int = 16,
                         rope_theta: float = 10000.0, r_in: int = 4,
                         r_w: int = 2,
                         points: Optional[Mapping[str, Sequence]] = None,
                         device=None):
    """A port `CIMDecodeLM` serving the given fp32 masters.

    Args:
      embed: (vocab, d) tied embedding.
      blocks: one mapping per transformer block with the layers "q", "k",
        "v" (d -> d each), "o" (d -> d), "gate", "up" (d -> d_ff each) and
        "down" (d_ff -> d), each {"w", "abn_log_gamma", "abn_beta"}.
      n_heads, window, rope_theta: the model's attention geometry.
      r_in, r_w: the base operating point.
      points: other operating points over the same masters, each one
        (r_in, r_w) pair or four in (qkv, o, gate_up, down) order.
      device: where the model runs (None means CUDA, as compile_program).
    Returns:
      The bound `repro_torch.runtime.scheduler.CIMDecodeLM`.
    """
    from repro_torch.runtime.scheduler import CIMDecodeLM
    masters = []
    for i, blk in enumerate(blocks):
        missing = [k for k in BLOCK_KEYS if k not in blk]
        if missing:
            raise ValueError(f"block {i} lacks {missing}")
        lay = {k: _layer(blk[k], "cpu") for k in BLOCK_KEYS}
        masters.append({"qkv": {k: lay[k] for k in ("q", "k", "v")},
                        "o": [lay["o"]],
                        "gate_up": {k: lay[k] for k in ("gate", "up")},
                        "down": [lay["down"]]})
    emb = torch.from_numpy(np.array(embed, dtype=np.float32))
    return CIMDecodeLM.from_masters(
        emb, masters, n_heads=n_heads, window=window, rope_theta=rope_theta,
        r_in=r_in, r_w=r_w, points=dict(points) if points else None,
        device=device)

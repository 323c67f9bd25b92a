"""Parameters of the JAX package, as numpy arrays, into the port's tensors.

The layouts match, so nothing is transposed: each CIM layer is
{"w": (K, N) with K in (kh, kw, c_in) order for a conv, "abn_log_gamma":
(N,), "abn_beta": (N,)}.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Union

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

"""Plain version of the draw kernel: `core/prng.normal_rows`, JAX's normal
per stream in PyTorch tensor ops (exact on the CPU and on the card)."""
from __future__ import annotations

import torch

from repro_torch.core.prng import normal_rows
from repro_torch.core.quantization import lint_opaque


# a draw is one fresh value to cimcheck, as the kernel call is opaque
@lint_opaque(record=False)
def threefry_normal_ref(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) float32 whose row s is `jax.random.normal(keys[s], (n,))`."""
    return normal_rows(keys, n)

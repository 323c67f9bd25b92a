"""JAX's threefry PRNG, bit for bit: keys, `fold_in`, `split`, random bits,
uniforms and normals.

Counterpart of the part of `jax.random` the JAX package calls, under JAX's
default `jax_threefry_partitionable` counter layout: element i of a draw
of any shape hashes the 64-bit counter (i >> 32, i & 0xffffffff) with
threefry-2x32 (`jax._src.prng.iota_2x32_shape`), and the draw keeps
`bits1 ^ bits2`.  A key is a `(..., 2)` pair of uint32 words held in an
int64 tensor (`torch.uint32` has no add on the CPU); every function
masks back to 32 bits, so the words stay in [0, 2^32).

    k = prng.key(0)                      # = jax.random.PRNGKey(0)
    k1 = prng.fold_in(k, 7)              # = jax.random.fold_in(k, 7)
    a, b = prng.split(k)                 # = jax.random.split(k)
    z = prng.normal(k1, (128, 16))       # = jax.random.normal(k1, ...)

`fold_in` broadcasts: a `(S, 2)` stack of keys folded with an `(S,)`
tensor of ids derives S stream keys in one pass, and `normal_rows(keys,
n)` draws `normal(keys[s], (n,))` for every stream s.  That is the plain
version of the CUDA draw kernel (`kernels/prng`).  The float steps of
`uniform` and `normal` follow XLA's CPU code (`core/xla_f32.py`), so the
floats equal JAX's on the CPU and on the card.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.xla_f32 import SQRT2, erf_inv_f32

M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# f32(nextafter(-1, 0)): the lower bound of normal's uniform
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

Word = Union[int, torch.Tensor]


def _rotl(x: Word, d: int) -> Word:
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word
                 ) -> Tuple[Word, Word]:
    """The threefry-2x32 block (20 rounds, JAX's key schedule) on uint32
    words held as Python ints or int64 tensors (broadcast together)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x1, x2


def _as_key(k) -> torch.Tensor:
    k = torch.as_tensor(k)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key is a (..., 2) uint32 pair, got shape "
                         f"{tuple(k.shape)}")
    if k.is_floating_point():
        raise ValueError(f"a key holds integers, got {k.dtype}")
    return k.to(torch.int64) & M32


def _u32(data) -> Word:
    """`jnp.asarray(data, uint32)`: ints wrap modulo 2^32 (an int32 id of
    -1 folds as 0xffffffff)."""
    if isinstance(data, torch.Tensor):
        if data.is_floating_point():
            raise ValueError(f"fold_in data must be integers, got "
                             f"{data.dtype}")
        return data.to(torch.int64) & M32
    data = int(data)
    if not -(1 << 31) <= data <= M32:
        raise ValueError(f"fold_in data {data} does not fit 32 bits")
    return data & M32


def key(seed: int, device=None) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for an int32 seed: the pair (0, seed mod
    2^32), as JAX builds it with 64-bit ints disabled."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed {seed} is not an int32 (JAX refuses it "
                         "without jax_enable_x64)")
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def fold_in(k, data) -> torch.Tensor:
    """`jax.random.fold_in(k, data)`: threefry of the counter (0,
    uint32(data)) under key k.  `k` is (..., 2) and `data` an int or an
    integer tensor that broadcasts against k[..., 0]; the result has the
    broadcast shape plus (2,), on k's device."""
    k = _as_key(k)
    d = _u32(data)
    if isinstance(d, torch.Tensor):
        d = d.to(k.device)
    elif k.shape == (2,) and k.device.type == "cpu":
        # one key, one id: Python ints, no tensor ops
        return torch.tensor(fold_in_int(key_ints(k), d), dtype=torch.int64)
    y1, y2 = threefry2x32(k[..., 0], k[..., 1], 0, d)
    return torch.stack([y1, y2], dim=-1)


def fold_in_int(k: Tuple[int, int], data: int) -> Tuple[int, int]:
    """fold_in on a key held as two Python ints (no tensor ops: the per-
    layer and per-tile keys of the engine's noise are derived this way)."""
    return threefry2x32(int(k[0]), int(k[1]), 0, _u32(data))


def key_ints(k) -> Tuple[int, int]:
    """A (2,) key as two Python ints."""
    k = _as_key(k).reshape(-1)
    if k.numel() != 2:
        raise ValueError("key_ints takes one key")
    return int(k[0]), int(k[1])


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """`iota_2x32_shape`: the flat index of each element as (hi, lo)."""
    n = 1
    for s in shape:
        n *= int(s)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return (idx >> 32).reshape(tuple(shape)), (idx & M32).reshape(tuple(shape))


def split(k, num: int = 2) -> torch.Tensor:
    """`jax.random.split(k, num)`: (num, 2) keys, threefry of the counters
    (0, i) (the partitionable, fold-like split)."""
    k = _as_key(k).reshape(2)
    if num <= 64 and k.device.type == "cpu":
        k1, k2 = key_ints(k)
        return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(num)],
                            dtype=torch.int64).reshape(num, 2)
    hi, lo = _counters((num,), k.device)
    y1, y2 = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([y1, y2], dim=-1)


def random_bits(k, shape: Sequence[int]) -> torch.Tensor:
    """`jax.random.bits(k, shape)` (uint32): bits1 ^ bits2 of each
    element's counter, as int64 values in [0, 2^32)."""
    k = _as_key(k).reshape(2)
    hi, lo = _counters(shape, k.device)
    y1, y2 = threefry2x32(k[0], k[1], hi, lo)
    return y1 ^ y2


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """Floats in [0, 1) from the top 23 bits (exponent of 1.0, minus 1)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return fb + -1.0


def uniform(k, shape: Sequence[int] = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """`jax.random.uniform(k, shape, float32, minval, maxval)`: floats in
    [0, 1) times (maxval - minval) plus minval, each step rounded, as the
    JAX source writes it.  XLA's CPU code fuses that multiply-add into one
    rounding, which differs from the source's two roundings unless the span
    is a power of two (the default [0, 1) and normal's bounds are); the
    JAX package draws no other uniform."""
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(hi - lo)
    f = _unit_floats(random_bits(k, shape))
    return torch.maximum(f * span + float(lo),
                         torch.tensor(float(lo), dtype=torch.float32,
                                      device=f.device))


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    u = _unit_floats(bits) * 2.0 + NORMAL_LO
    u = torch.maximum(u, torch.tensor(NORMAL_LO, dtype=torch.float32,
                                      device=u.device))
    return erf_inv_f32(u) * SQRT2


def normal(k, shape: Sequence[int] = ()) -> torch.Tensor:
    """`jax.random.normal(k, shape)` in float32: sqrt(2) * erf_inv of a
    uniform on [nextafter(-1, 0), 1)."""
    return _normal_from_bits(random_bits(k, shape))


def normal_rows(keys, n: int) -> torch.Tensor:
    """(S, n) float32 whose row s is `normal(keys[s], (n,))`: the plain
    version of the draw kernel (`kernels/prng/kernel.threefry_normal`)."""
    keys = _as_key(keys).reshape(-1, 2)
    hi, lo = _counters((1, n), keys.device)
    y1, y2 = threefry2x32(keys[:, :1], keys[:, 1:], hi, lo)
    return _normal_from_bits(y1 ^ y2)

"""JAX's threefry normal draws on Hopper (`csrc/threefry_normal.cu`).

`threefry_normal(keys, n)` draws `(S, n)` float32 whose row s is
`jax.random.normal(keys[s], (n,))` bit for bit, for keys held as the
port's `(S, 2)` int64 uint32 pairs (`core/prng`).  Every caller of the
noise model draws through it: the engine's positional draws (one stream
per 128-row block of a layer's (row tile, col tile) fields, n = 128 *
tile_n), its identity-keyed draws (one stream per GEMM row, n = tile_n),
fakequant's thermal field of a row tile (one stream, n = numel) and its
SA residues (one stream of 256).

A CUDA tensor of keys launches the kernel or raises; only keys on the
CPU take the plain version (`ref.threefry_normal_ref`).
`threefry_normal.launches` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def _library() -> ctypes.CDLL:
    lib = build.load("threefry_normal")
    fn = lib.threefry_normal_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.threefry_normal_error_string.argtypes = [ctypes.c_int]
        lib.threefry_normal_error_string.restype = ctypes.c_char_p
    return lib


def threefry_normal(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) float32 normals, row s drawn under keys[s] ((S, 2) int64)."""
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be (S, 2), got {tuple(keys.shape)}")
    n = int(n)
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    if keys.device.type == "cpu":
        from repro_torch.kernels.prng.ref import threefry_normal_ref
        return threefry_normal_ref(keys, n)
    if keys.device.type != "cuda":
        raise ValueError(f"no threefry_normal kernel for device "
                         f"{keys.device}")
    keys = (keys.to(torch.int64) & 0xFFFFFFFF).contiguous()
    out = torch.empty((keys.shape[0], n), dtype=torch.float32,
                      device=keys.device)
    if out.numel() == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = lib.threefry_normal_launch(keys.data_ptr(), out.data_ptr(),
                                     keys.shape[0], n, stream)
    if err:
        msg = lib.threefry_normal_error_string(err).decode()
        raise RuntimeError(f"threefry_normal launch failed: error {err} "
                           f"({msg})")
    threefry_normal.launches += 1
    return out


threefry_normal.launches = 0

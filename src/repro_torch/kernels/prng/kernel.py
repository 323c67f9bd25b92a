"""JAX's threefry normal draws on Hopper (`csrc/threefry_normal.cu`).

`threefry_normal(keys, n)` draws `(S, n)` float32 whose row s is
`jax.random.normal(keys[s], (n,))` bit for bit, for keys held as the
port's `(S, 2)` int64 uint32 pairs (`core/prng`).  Every caller of the
noise model draws through it: the engine's positional draws (one stream
per 128-row block of a layer's (row tile, col tile) fields, n = 128 *
tile_n), its identity-keyed draws (one stream per GEMM row, n = tile_n),
fakequant's thermal field of a row tile (one stream, n = numel) and its
SA residues (one stream of 256).

`normal_of_bits(bits)` maps bit patterns to normals through the draw's
own device code: the exhaustive check of its float chain over all 2^23
patterns a normal can come from (chip_smoke.py), not a main-path entry.

A CUDA tensor launches the kernel or raises; only a tensor on the CPU
takes the plain version (`ref.threefry_normal_ref`,
`core/prng._normal_from_bits`).  `threefry_normal.launches` counts the
draw's launches.  On the `meta` device (a dry run) `threefry_normal`
launches nothing: it returns an empty meta tensor and records one op of
the draw's work (`kernels/costs.py`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, costs

# consecutive normals of a stream a thread computes a trip (csrc's K)
NORMALS_A_TRIP = 4


def _library() -> ctypes.CDLL:
    lib = build.load("threefry_normal")
    fn = lib.threefry_normal_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                       ctypes.c_uint, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        bits = lib.threefry_normal_of_bits_launch
        bits.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_void_p]
        bits.restype = ctypes.c_int
        lib.threefry_normal_error_string.argtypes = [ctypes.c_int]
        lib.threefry_normal_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=256)
def _divider(d: int) -> tuple:
    """(mul, sh1, sh2) such that u // d == (t + ((u - t) >> sh1)) >> sh2
    with t = (u * mul) >> 32, for every u < 2^32 and 1 <= d < 2^32: the
    kernel's divide of a unit index by the units a stream, one multiply-
    high and a few integer instructions (Granlund and Montgomery's round-up
    method as libdivide writes it without branches)."""
    if not 1 <= d < 1 << 32:
        raise ValueError(f"divisor {d} outside [1, 2^32)")
    lg = (d - 1).bit_length()               # ceil(log2 d)
    mul = ((1 << 32) * ((1 << lg) - d)) // d + 1
    return mul, min(lg, 1), max(lg - 1, 0)


def _stream(dev: torch.device) -> int:
    """The current CUDA stream of `dev` as a raw handle: what
    `torch.cuda.current_stream(dev).cuda_stream` gives, without building
    a Stream object (a draw is launched thousands of times a step, and
    that object costs about as much host time as the launch itself)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _check(err: int, lib: ctypes.CDLL, what: str) -> None:
    if err:
        msg = lib.threefry_normal_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: error {err} ({msg})")


def threefry_normal(keys: torch.Tensor, n: int) -> torch.Tensor:
    """(S, n) float32 normals, row s drawn under keys[s] ((S, 2) int64)."""
    if keys.dim() != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be (S, 2), got {tuple(keys.shape)}")
    n = int(n)
    if n < 0:
        raise ValueError(f"n must be >= 0, got {n}")
    dev = keys.device
    if dev.type == "cpu":
        from repro_torch.kernels.prng.ref import threefry_normal_ref
        return threefry_normal_ref(keys, n)
    if dev.type == "meta":
        costs.record("threefry_normal",
                     costs.threefry_normal(keys.shape[0], n))
        return torch.empty((keys.shape[0], n), dtype=torch.float32,
                           device="meta")
    if dev.type != "cuda":
        raise ValueError(f"no threefry_normal kernel for device {dev}")
    if keys.dtype != torch.int64:
        raise ValueError(f"keys must be int64, got {keys.dtype}")
    # the kernel reads a key as one 16-byte vector, the low word of each
    # half a key word
    keys = keys.contiguous()
    if keys.data_ptr() % 16:
        keys = keys.clone()
    streams = keys.shape[0]
    out = torch.empty((streams, n), dtype=torch.float32, device=dev)
    if streams == 0 or n == 0:
        return out
    per_row = -(-n // NORMALS_A_TRIP)
    # from 2^31 units the kernel divides in 64 bits and ignores these
    mul, sh1, sh2 = (_divider(per_row) if streams * per_row < 1 << 31
                     else (1, 0, 0))
    lib = _library()
    err = lib.threefry_normal_launch(keys.data_ptr(), out.data_ptr(),
                                     streams, n, mul, sh1, sh2, dev.index,
                                     _stream(dev))
    _check(err, lib, "threefry_normal")
    threefry_normal.launches += 1
    return out


threefry_normal.launches = 0


def normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 normals of int64 bit patterns in [0, 2^32), one each, as the
    draw computes them from a counter's bits1 ^ bits2 (same shape)."""
    if bits.dtype != torch.int64:
        raise ValueError(f"bits must be int64, got {bits.dtype}")
    if bits.device.type == "cpu":
        from repro_torch.core.prng import _normal_from_bits
        return _normal_from_bits(bits)
    if bits.device.type != "cuda":
        raise ValueError(f"no normal_of_bits kernel for device "
                         f"{bits.device}")
    bits = bits.contiguous()
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    if out.numel() == 0:
        return out
    lib = _library()
    _check(lib.threefry_normal_of_bits_launch(bits.data_ptr(),
                                              out.data_ptr(), bits.numel(),
                                              _stream(bits.device)),
           lib, "normal_of_bits")
    return out

"""Ring-buffer decode attention on Hopper.

Counterpart of `repro/kernels/flash_attn/ops.py:_ring_decode_kernel`.  The
kernel itself is CUDA C++ (`csrc/ring_decode.cu`, built by
`kernels/build.py` and called through a plain C interface with ctypes);
this module is its wrapper.

`ring_decode` launches the CUDA kernel for tensors on a CUDA device and
runs the plain PyTorch version (`ref.ring_decode_attention_ref`) for
tensors on the CPU.  A CUDA tensor never reaches the plain version: a
launch either happens or raises.  `ring_decode.launches` counts the
kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

# the design keeps a row's L scores in dynamic shared memory, without the
# opt-in above 48 KB, and q spread over at most 8 values per lane
MAX_WINDOW = 48 * 1024 // 4
MAX_HEAD_DIM = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURE = ([_P] * 5                      # q, k, v, bias, out
              + [_I] * 4                    # R, L, H, hd
              + [_L] * 11                   # strides
              + [ctypes.c_float, _P])       # sqrt(hd), cudaStream_t


def _library() -> ctypes.CDLL:
    lib = build.load("ring_decode")
    fn = lib.ring_decode_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        lib.ring_decode_error_string.argtypes = [ctypes.c_int]
        lib.ring_decode_error_string.restype = ctypes.c_char_p
    return lib


def _check_shapes(q, k, v, bias) -> None:
    if q.dim() != 3 or k.dim() != 4 or bias.dim() != 2:
        raise ValueError(
            f"need q (R, H, hd), k/v (R, L, H, hd), bias (R, L); got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, bias {tuple(bias.shape)}")
    r, h, hd = q.shape
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != r \
            or tuple(k.shape[2:]) != (h, hd) \
            or tuple(bias.shape) != (r, k.shape[1]):
        raise ValueError(
            f"shapes do not fit: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, bias {tuple(bias.shape)}")
    if k.shape[1] < 1:
        raise ValueError("the KV ring needs at least one slot")


def ring_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """softmax(q . k / sqrt(hd) + bias) . v per row over its own ring.

    q    : (R, H, hd) float32
    k, v : (R, L, H, hd) float32, any strides with the head dimension
           contiguous (a block's slab of the decode state passes as a view)
    bias : (R, L) float32 additive slot mask, slots contiguous
    returns (R, H, hd) float32
    """
    _check_shapes(q, k, v, bias)
    if q.device.type == "cpu":
        from repro_torch.kernels.flash_attn.ref import \
            ring_decode_attention_ref
        return ring_decode_attention_ref(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"no ring_decode kernel for device {q.device}")
    r, h, hd = q.shape
    win = k.shape[1]
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.dtype != torch.float32 or t.device != q.device \
                or t.stride(-1) != 1:
            raise ValueError(
                f"{name} must be float32 on {q.device} with a contiguous "
                f"last dimension, got {t.dtype} on {t.device} with strides "
                f"{t.stride()}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} > {MAX_HEAD_DIM}, more than the "
                         "kernel's per-lane q registers hold")
    if win > MAX_WINDOW:
        raise ValueError(f"KV window {win} > {MAX_WINDOW}, more scores than "
                         "the kernel's shared memory holds")
    out = torch.empty((r, h, hd), dtype=torch.float32, device=q.device)
    if r == 0 or h == 0 or hd == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ring_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), r, win, h, hd,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), bias.stride(0),
        out.stride(0), out.stride(1),
        ctypes.c_float(math.sqrt(hd)), stream)
    if err:
        raise RuntimeError(
            f"ring_decode kernel launch failed: CUDA error {err} "
            f"({lib.ring_decode_error_string(err).decode()})")
    ring_decode.launches += 1
    return out


ring_decode.launches = 0

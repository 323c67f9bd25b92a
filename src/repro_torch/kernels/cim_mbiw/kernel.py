"""The CIM-MBIW quantized matmul with fused DSCI-ADC, on Hopper.

Counterpart of `repro/kernels/cim_mbiw/kernel.py`.  The kernel itself is
CUDA C++ (`csrc/cim_mbiw.cu`, built by `kernels/build.py` and called
through a plain C interface with ctypes); this module is its wrapper.

`cim_mbiw_matmul_planes` launches the CUDA kernel for tensors on a CUDA
device and runs the plain PyTorch version
(`ref.cim_mbiw_matmul_planes_ref`) for tensors on the CPU.  A CUDA tensor
never reaches the plain version: a launch either happens or raises.
`cim_mbiw_matmul_planes.launches` counts the kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def plane_layout(r_in: int) -> tuple[int, int]:
    """(plane_shift, n_planes) of the input-serial walk at a given r_in.

    Bit-serial below 3b (the macro's high-throughput binary modes),
    nibble-serial at 3-8b.  Weights stay *parallel* at every r_w - the
    MBIW combines weight bits spatially across adjacent columns, so the
    kernel sees them as pre-decoded odd integers.
    """
    if not 1 <= r_in <= 8:
        raise ValueError(f"r_in={r_in} outside the macro's 1-8b range")
    shift = 1 if r_in <= 2 else 4
    return shift, -(-r_in // shift)


_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURE = [_P, _P, _P, _P, _P,          # x, w, gamma, beta, out
              _I, _I, _I, _I, _I,          # M, N, K, P, plane_shift
              ctypes.c_float, _I, _I, _I,  # g0, r_out, fuse_adc, beta_rows
              _P]                          # cudaStream_t


def _library() -> ctypes.CDLL:
    lib = build.load("cim_mbiw")
    fn = lib.cim_mbiw_launch
    if fn.argtypes is None:
        fn.argtypes = _SIGNATURE
        fn.restype = ctypes.c_int
        lib.cim_mbiw_error_string.argtypes = [ctypes.c_int]
        lib.cim_mbiw_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.dtype != dtype or t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})")


def cim_mbiw_matmul_planes(x_planes: torch.Tensor, w_q: torch.Tensor,
                           gamma: torch.Tensor, beta: torch.Tensor, *,
                           plane_shift: int, g0: float, r_out: int,
                           fuse_adc: bool = True) -> torch.Tensor:
    """CIM matmul over input planes (any M, N, K: the kernel masks edges).

    x_planes : (M, P*K) int8 - P planes laid out plane-major along the last
               axis; plane p carries bits [p*plane_shift, ...).
    w_q      : (K, N) int8 odd weights (+/-(2^r_w - 1))
    gamma    : (1, N) float32 ABN gain
    beta     : (1, N) float32 ABN offset in ADC codes - or (M, N) for a
               per-GEMM-row offset
    returns  : (M, N) int32 ADC codes in [0, 2^r_out - 1], or the raw int32
               dp accumulator when `fuse_adc=False`
    """
    m, pk = x_planes.shape
    k_dim, n = w_q.shape
    if k_dim < 1 or pk % k_dim:
        raise ValueError(f"x_planes width {pk} is not a multiple of K={k_dim}")
    if tuple(gamma.shape) != (1, n) or tuple(beta.shape) not in ((1, n),
                                                                 (m, n)):
        raise ValueError(f"gamma {tuple(gamma.shape)} / beta "
                         f"{tuple(beta.shape)} do not fit (M, N)=({m}, {n})")
    if x_planes.device.type == "cpu":
        from repro_torch.kernels.cim_mbiw.ref import cim_mbiw_matmul_planes_ref
        return cim_mbiw_matmul_planes_ref(
            x_planes, w_q, gamma, beta, plane_shift=plane_shift, g0=g0,
            r_out=r_out, fuse_adc=fuse_adc)
    if x_planes.device.type != "cuda":
        raise ValueError(f"no cim_mbiw kernel for device {x_planes.device}")
    dev = x_planes.device
    _check(x_planes, "x_planes", torch.int8, dev)
    _check(w_q, "w_q", torch.int8, dev)
    _check(gamma, "gamma", torch.float32, dev)
    _check(beta, "beta", torch.float32, dev)
    out = torch.empty((m, n), dtype=torch.int32, device=dev)
    if m == 0 or n == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.cim_mbiw_launch(
        x_planes.data_ptr(), w_q.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), out.data_ptr(), m, n, k_dim, pk // k_dim,
        plane_shift, ctypes.c_float(g0), r_out, int(fuse_adc),
        int(beta.shape[0] == m and m != 1), stream)
    if err:
        raise RuntimeError(f"cim_mbiw kernel launch failed: CUDA error {err} "
                           f"({lib.cim_mbiw_error_string(err).decode()})")
    cim_mbiw_matmul_planes.launches += 1
    return out


cim_mbiw_matmul_planes.launches = 0

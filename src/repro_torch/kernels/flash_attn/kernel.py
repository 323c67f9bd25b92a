"""Attention kernels on Hopper: ring-buffer decode and flash attention.

Counterparts of `repro/kernels/flash_attn/ops.py:_ring_decode_kernel` and
of `repro/kernels/flash_attn/kernel.py`'s `_flash_kernel`,
`_flash_bwd_dq_kernel` and `_flash_bwd_dkv_kernel`.  The kernels are CUDA
C++ (`csrc/ring_decode.cu`, `csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`, and
the tensor-core `csrc/flash_fwd_tc.cu`, `csrc/flash_bwd_dq_tc.cu` and
`csrc/flash_bwd_dkv_tc.cu`, built by `kernels/build.py` and called
through a plain C interface with ctypes); this module holds their
wrappers.

Each wrapper launches its CUDA kernel for tensors on a CUDA device and
runs its plain PyTorch version (`ref.py`) for tensors on the CPU.  A CUDA
tensor never reaches the plain version: a launch either happens or
raises.  `<wrapper>.launches` counts the kernels launched (a
`ring_decode` call launches two, a chunk kernel and a merge kernel).
`flash_fwd`, `flash_bwd_dq` and `flash_bwd_dkv` route bfloat16 inputs
with D in their row of `FLASH_TC_HEAD_DIMS` (64, 128 and 256 for each)
to the tensor-core kernels (counted again in `<wrapper>.launches_tc`)
and everything else to the CUDA-core kernels of `flash_fwd.cu` and
`flash_bwd.cu`, which take any D up to `FLASH_MAX_HEAD_DIM` (256; above
it a call raises ValueError).

On the `meta` device (a dry run, `launch/dryrun.py`) a wrapper launches
nothing and counts nothing: it returns empty meta tensors of its result's
shapes and records one op with the work of the function it computes
(`kernels/costs.py`).  The flash kernels' work depends on the q offset,
which a meta tensor does not hold: an offset made by `offset_tensor`
keeps its host value for the meta route; any other raises there.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.kernels import build, costs

# ring_decode splits a row's slots into chunks of RING_CHUNK (the CHUNK of
# csrc/ring_decode.cu, which checks the partials' size it is given); its
# merge keeps one weight a chunk in shared memory (96 of them), and a lane
# holds at most 8 values of q, k, v and the output
RING_CHUNK = 128
MAX_WINDOW = 96 * RING_CHUNK
MAX_HEAD_DIM = 256
# kernels a ring_decode call launches: the chunk kernel and the merge
RING_KERNELS = 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURE = ([_P] * 6                      # q, k, v, bias, out, work
              + [_L] + [_I] * 4             # work floats, R, L, H, hd
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
    if q.device.type == "meta":
        costs.record("ring_decode", costs.ring_decode(
            q.shape[0], k.shape[1], q.shape[1], q.shape[2]))
        return torch.empty(q.shape, dtype=torch.float32, device="meta")
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
        raise ValueError(f"KV window {win} > {MAX_WINDOW}, more chunks than "
                         "the merge kernel's shared memory holds")
    out = torch.empty((r, h, hd), dtype=torch.float32, device=q.device)
    if r == 0 or h == 0 or hd == 0:
        return out
    _launch(q, k, v, bias, out)
    return out


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the chunk and merge kernels on checked tensors into `out`
    and count both."""
    r, h, hd = q.shape
    win = k.shape[1]
    # the chunk partials: o (hd floats), max and sum per (row, head, chunk)
    n_chunks = -(-win // RING_CHUNK)
    work = torch.empty(r * h * n_chunks * (hd + 2), dtype=torch.float32,
                       device=q.device)
    lib = _library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.ring_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), work.data_ptr(), work.numel(), r, win, h, hd,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), bias.stride(0),
        out.stride(0), out.stride(1),
        ctypes.c_float(math.sqrt(hd)), stream)
    if err:
        raise RuntimeError(
            f"ring_decode kernel launch failed: CUDA error {err} "
            f"({lib.ring_decode_error_string(err).decode()})")
    ring_decode.launches += RING_KERNELS


ring_decode.launches = 0


# ---------------------------------------------------------------------------
# flash attention forward and backward
# ---------------------------------------------------------------------------

# the CUDA-core kernels hold D / 16 values a thread per row, compiled for
# D <= 128 and for D <= 256 (csrc/flash_common.cuh)
FLASH_MAX_HEAD_DIM = 256
_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# head dimensions each tensor-core kernel is built for (bf16 inputs), by
# wrapper
FLASH_TC_HEAD_DIMS = {"flash_fwd": (64, 128, 256),
                      "flash_bwd_dq": (64, 128, 256),
                      "flash_bwd_dkv": (64, 128, 256)}

# entry point -> (leading dtype argument?, tensor pointers)
_FLASH_ENTRIES = {
    "flash_fwd": {"flash_fwd_launch": (True, 6)},
    "flash_bwd": {"flash_bwd_dq_launch": (True, 8),
                  "flash_bwd_dkv_launch": (True, 9)},
    "flash_fwd_tc": {"flash_fwd_tc_launch": (False, 6)},
    "flash_bwd_dkv_tc": {"flash_bwd_dkv_tc_launch": (False, 9)},
    "flash_bwd_dq_tc": {"flash_bwd_dq_tc_launch": (False, 8)},
}


def _flash_library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    for fn_name, (dtype_arg, n_ptr) in _FLASH_ENTRIES[name].items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = ([_I] * dtype_arg + [_P] * n_ptr   # dtype, tensors
                           + [ctypes.POINTER(_L)]            # strides
                           + [_I] * 8                        # B .. window
                           + [ctypes.c_float, _P])           # scale, stream
            fn.restype = ctypes.c_int
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    return lib


def _bshd_strides(t: torch.Tensor) -> tuple:
    """(b, s, h) element strides of a (B, H, S, D)-indexed tensor."""
    return t.stride(0), t.stride(2), t.stride(1)


# the host value of each q offset made on the meta device by offset_tensor
_META_OFFSETS = WeakIdKeyDictionary()


def offset_tensor(value: int, device) -> torch.Tensor:
    """The (1, 1) int32 q offset `value` on `device`, as the flash
    kernels take it; on the meta device its value is kept for the meta
    routes' count."""
    t = torch.full((1, 1), int(value), dtype=torch.int32, device=device)
    if t.device.type == "meta":
        _META_OFFSETS[t] = int(value)
    return t


def _meta_flash(kind: str, q, k, q_off, causal: bool, window: int) -> None:
    """Record one flash kernel op of `kind` on meta tensors
    (`costs.flash` over the pairs the mask keeps at the offset's host
    value)."""
    off = _META_OFFSETS.get(q_off)
    if off is None:
        raise ValueError(
            "flash on the meta device reads its q offset on the host, and "
            "this offset is a device value (make it with offset_tensor)")
    b, h, sq, d = q.shape
    costs.record(f"flash_{kind}" if kind == "fwd" else f"flash_bwd_{kind}",
                 costs.flash(kind, b, h, k.shape[1], sq, k.shape[2], d,
                             causal, window, q.element_size(), off))


def _check_flash(q, k, v, q_off, extra=()) -> None:
    """Shapes, dtypes and devices the flash kernels take: q (B, H, Sq, D),
    k/v (B, G, Sk, D) with G dividing H, q/k/v/extra of one float dtype
    (float32 or bfloat16) with the head dimension contiguous, q_off one
    int32 on the same device."""
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"need q (B, H, Sq, D), k/v (B, G, Sk, D); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or k.shape[1] < 1 \
            or h % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "fit (batch, head dim, or kv heads dividing heads)")
    if k.shape[2] < 1:
        raise ValueError("attention needs at least one key")
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    if q_off.numel() != 1 or q_off.dtype != torch.int32 \
            or q_off.device != q.device:
        raise ValueError(f"q_off must be one int32 on {q.device}, got "
                         f"{tuple(q_off.shape)} {q_off.dtype} on "
                         f"{q_off.device}")


def _check_cuda_flash(q, tensors) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    if q.dtype not in _FLASH_DTYPES:
        raise ValueError(f"the flash kernels take float32 or bfloat16, got "
                         f"{q.dtype}")
    if q.shape[3] > FLASH_MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[3]} > {FLASH_MAX_HEAD_DIM}, "
                         "more than the kernels' registers hold")
    for name, t in tensors:
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last dimension, "
                             f"got strides {t.stride()}")


def _tensor_core_route(kernel: str, q: torch.Tensor, tensors) -> bool:
    """Whether a CUDA call of wrapper `kernel` goes to its tensor-core
    kernel: bfloat16 with D in FLASH_TC_HEAD_DIMS[kernel].  Their TMA loads
    need each bf16 operand 16-byte aligned with (b, s, h) strides that are
    multiples of 8 elements; a call on that route that does not meet this
    raises."""
    if q.dtype != torch.bfloat16 \
            or q.shape[3] not in FLASH_TC_HEAD_DIMS[kernel]:
        return False
    for name, t in tensors:
        if t.data_ptr() % 16 or any(st % 8 for st in _bshd_strides(t)):
            raise ValueError(
                f"{name} (strides {t.stride()}) is not aligned for the "
                "tensor-core kernels' TMA loads: 16-byte base, batch, "
                "sequence and head strides multiples of 8")
    return True


def _raise_on(err: int, lib: ctypes.CDLL, name: str, what: str) -> None:
    if err:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_off: torch.Tensor, *, causal: bool, window: int = 0):
    """Flash attention forward (`_flash_kernel`).

    q (B, H, Sq, D), k/v (B, G, Sk, D) float32 or bfloat16, any strides
    with D contiguous (the model passes (B, S, H, D) tensors transposed);
    q_off one int32, the global position of query row 0.  Returns O
    (B, H, Sq, D) in q's dtype, a view of a contiguous (B, Sq, H, D)
    buffer, and the row logsumexp lse (B, H, Sq) float32.  bfloat16 at D
    64, 128 or 256 runs on the tensor cores (`flash_fwd_tc.cu`), anything
    else on the CUDA cores (`flash_fwd.cu`)."""
    _check_flash(q, k, v, q_off)
    if q.device.type == "cpu":
        from repro_torch.kernels.flash_attn.ref import flash_fwd_ref
        return flash_fwd_ref(q, k, v, q_off, causal=causal, window=window)
    if q.device.type == "meta":
        _meta_flash("fwd", q, k, q_off, causal, window)
        b, h, sq, d = q.shape
        return (torch.empty((b, sq, h, d), dtype=q.dtype,
                            device="meta").transpose(1, 2),
                torch.empty((b, h, sq), dtype=torch.float32, device="meta"))
    _check_cuda_flash(q, (("q", q), ("k", k), ("v", v)))
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, d), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b == 0 or h == 0 or sq == 0:
        return o, lse
    st = (ctypes.c_longlong * 12)(*(_bshd_strides(q) + _bshd_strides(k)
                                    + _bshd_strides(v) + _bshd_strides(o)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), q_off.data_ptr(),
            o.data_ptr(), lse.data_ptr(), st, b, h, h // g, sq, sk, d,
            int(causal), int(window), 1.0 / (d ** 0.5),
            torch.cuda.current_stream(q.device).cuda_stream)
    if _tensor_core_route("flash_fwd", q, (("q", q), ("k", k), ("v", v))):
        lib = _flash_library("flash_fwd_tc")
        _raise_on(lib.flash_fwd_tc_launch(*args), lib, "flash_fwd_tc",
                  "flash forward (tensor cores)")
        flash_fwd.launches_tc += 1
    else:
        lib = _flash_library("flash_fwd")
        _raise_on(lib.flash_fwd_launch(_FLASH_DTYPES[q.dtype], *args), lib,
                  "flash_fwd", "flash forward")
    flash_fwd.launches += 1
    return o, lse


def _bwd_operands(q, k, v, do, lse, delta, q_off):
    _check_flash(q, k, v, q_off, extra=(("do", do),))
    if tuple(do.shape) != tuple(q.shape) \
            or tuple(lse.shape) != tuple(q.shape[:3]) \
            or tuple(delta.shape) != tuple(q.shape[:3]):
        raise ValueError(f"do must be shaped like q {tuple(q.shape)} and "
                         f"lse/delta (B, H, Sq); got do {tuple(do.shape)}, "
                         f"lse {tuple(lse.shape)}, delta "
                         f"{tuple(delta.shape)}")
    if q.device.type not in ("cpu", "meta"):
        _check_cuda_flash(q, (("q", q), ("k", k), ("v", v), ("do", do)))
        for name, t in (("lse", lse), ("delta", delta)):
            if t.dtype != torch.float32 or not t.is_contiguous() \
                    or t.device != q.device:
                raise ValueError(f"{name} must be contiguous float32 on "
                                 f"{q.device}")


def flash_bwd_dq(q, k, v, do, lse, delta, q_off, *, causal: bool,
                 window: int = 0) -> torch.Tensor:
    """dq of flash attention (`_flash_bwd_dq_kernel`): q, do (B, H, Sq, D)
    and k/v (B, G, Sk, D) as `flash_fwd` takes them, lse and delta =
    rowsum(dO * O) (B, H, Sq) float32.  Returns dq (B, H, Sq, D) float32,
    a view of a contiguous (B, Sq, H, D) buffer.  bfloat16 at D 64, 128 or
    256 runs on the tensor cores (`flash_bwd_dq_tc.cu`), anything else on
    the CUDA cores (`flash_bwd.cu`)."""
    _bwd_operands(q, k, v, do, lse, delta, q_off)
    if q.device.type == "cpu":
        from repro_torch.kernels.flash_attn.ref import flash_bwd_dq_ref
        return flash_bwd_dq_ref(q, k, v, do, lse, delta, q_off,
                                causal=causal, window=window)
    b, h, sq, d = q.shape
    if q.device.type == "meta":
        _meta_flash("dq", q, k, q_off, causal, window)
        return torch.empty((b, sq, h, d), dtype=torch.float32,
                           device="meta").transpose(1, 2)
    g, sk = k.shape[1], k.shape[2]
    dq = torch.empty((b, sq, h, d), dtype=torch.float32,
                     device=q.device).transpose(1, 2)
    if b == 0 or h == 0 or sq == 0:
        return dq
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), q_off.data_ptr(),
            dq.data_ptr())
    rest = (b, h, h // g, sq, sk, d, int(causal), int(window),
            1.0 / (d ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    strides = (_bshd_strides(q) + _bshd_strides(k) + _bshd_strides(v)
               + _bshd_strides(do) + _bshd_strides(dq))
    if _tensor_core_route("flash_bwd_dq", q,
                          (("q", q), ("k", k), ("v", v), ("do", do))):
        lib = _flash_library("flash_bwd_dq_tc")
        st = (ctypes.c_longlong * 15)(*strides)
        _raise_on(lib.flash_bwd_dq_tc_launch(*ptrs, st, *rest), lib,
                  "flash_bwd_dq_tc", "flash dq (tensor cores)")
        flash_bwd_dq.launches_tc += 1
    else:
        lib = _flash_library("flash_bwd")
        st = (ctypes.c_longlong * 21)(*(strides + (0,) * 6))
        _raise_on(lib.flash_bwd_dq_launch(_FLASH_DTYPES[q.dtype], *ptrs, st,
                                          *rest), lib, "flash_bwd",
                  "flash dq")
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, q_off, *, causal: bool,
                  window: int = 0):
    """dk and dv of flash attention per query head
    (`_flash_bwd_dkv_kernel`), operands as `flash_bwd_dq`.  Returns dk, dv
    (B, H, Sk, D) float32, views of contiguous (B, Sk, H, D) buffers; the
    caller sums each kv group's rep heads.  bfloat16 at D 64, 128 or 256
    runs on the tensor cores (`flash_bwd_dkv_tc.cu`), anything else on the
    CUDA cores (`flash_bwd.cu`)."""
    _bwd_operands(q, k, v, do, lse, delta, q_off)
    if q.device.type == "cpu":
        from repro_torch.kernels.flash_attn.ref import flash_bwd_dkv_ref
        return flash_bwd_dkv_ref(q, k, v, do, lse, delta, q_off,
                                 causal=causal, window=window)
    b, h, sq, d = q.shape
    g, sk = k.shape[1], k.shape[2]
    if q.device.type == "meta":
        _meta_flash("dkv", q, k, q_off, causal, window)
        dk = torch.empty((b, sk, h, d), dtype=torch.float32,
                         device="meta").transpose(1, 2)
        return dk, torch.empty_like(dk)
    dk = torch.empty((b, sk, h, d), dtype=torch.float32,
                     device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    if b == 0 or h == 0:
        return dk, dv
    if sq == 0:
        return dk.zero_(), dv.zero_()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), q_off.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    rest = (b, h, h // g, sq, sk, d, int(causal), int(window),
            1.0 / (d ** 0.5), torch.cuda.current_stream(q.device).cuda_stream)
    strides = (_bshd_strides(q) + _bshd_strides(k) + _bshd_strides(v)
               + _bshd_strides(do))
    if _tensor_core_route("flash_bwd_dkv", q,
                          (("q", q), ("k", k), ("v", v), ("do", do))):
        lib = _flash_library("flash_bwd_dkv_tc")
        st = (ctypes.c_longlong * 18)(*(strides + _bshd_strides(dk)
                                        + _bshd_strides(dv)))
        _raise_on(lib.flash_bwd_dkv_tc_launch(*ptrs, st, *rest), lib,
                  "flash_bwd_dkv_tc", "flash dk/dv (tensor cores)")
        flash_bwd_dkv.launches_tc += 1
    else:
        lib = _flash_library("flash_bwd")
        st = (ctypes.c_longlong * 21)(*(strides + (0,) * 3
                                        + _bshd_strides(dk)
                                        + _bshd_strides(dv)))
        _raise_on(lib.flash_bwd_dkv_launch(_FLASH_DTYPES[q.dtype], *ptrs, st,
                                           *rest), lib, "flash_bwd",
                  "flash dk/dv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_fwd.launches = 0
flash_fwd.launches_tc = 0
flash_bwd_dq.launches = 0
flash_bwd_dq.launches_tc = 0
flash_bwd_dkv.launches = 0
flash_bwd_dkv.launches_tc = 0

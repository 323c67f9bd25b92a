"""Roofline terms of one step from its stream of aten ops on the meta device.

Counterpart of `repro/launch/hlo_analysis.py`.  The JAX package compiles a
step and walks the scheduled HLO; the port runs the step once, eagerly, on
`meta` tensors (shapes and dtypes, no storage, no arithmetic) under a
`TorchDispatchMode` that sees every aten call below autograd, the
backward's included, and sums as it goes (no graph is kept: a full-size
train step makes some 10^5 ops).  The walk is eager, so loops over layers
come out unrolled and no trip count multiplies anything.

  * flops: 2·M·N·K for every `mm` / `bmm` / `addmm` / `baddbmm` (and `mv`
    / `dot`), 2 x output elements x (input channels / groups x kernel
    elements) for every `convolution` and each gradient of a
    `convolution_backward`, plus each port kernel's own count: a kernel
    called on meta tensors records one op with the work of the function
    it computes (`kernels/costs.py`), not the plain version's arithmetic;
  * hbm_bytes: operand plus result bytes of every compute op.  Views and
    `empty` are free; a gather (`embedding`, `index`, `index_select`,
    `gather`) moves its indices and the rows it gathers (read and
    written), a scatter (`index_put`, `index_add`, `scatter*`,
    `index_copy`) its indices and the rows it updates, as
    `hlo_analysis.hbm_bytes` charges gathered and updated rows rather than
    the whole buffer.  Elementwise ops are included: eager PyTorch writes
    each one out;
  * hbm_bytes_fused: the same without the ops of `hlo_analysis`'s
    `_ELEMENTWISE` set (their aten names in `ELEMENTWISE`), which XLA
    fuses into their consumers on a TPU: the number to set beside JAX's
    `hlo_bytes`;
  * live bytes: every storage a call creates is held from its creation
    until it is freed (a weak reference on the storage), so the peak over
    the walk, less the arguments, is the step's temporary memory.

`OpStream` is the mode; `analyze(fn, args)` runs `fn()` under it with
`args` (a tree of tensors) held as arguments and returns the sums.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import costs

# hlo_analysis._ELEMENTWISE's ops by their aten names (an in-place form
# is the same op): convert, multiply, add, subtract, divide, select,
# compare, and / or / not / xor, exponential, log, rsqrt, sqrt, tanh,
# logistic, maximum, minimum, abs, negate, sign, floor, ceil, round,
# broadcast (a constant fill), power, remainder, clamp,
# exponential-minus-one, log-plus-one
ELEMENTWISE = frozenset({
    "_to_copy", "mul", "add", "sub", "rsub", "div", "where", "eq", "ne",
    "lt", "le", "gt", "ge", "bitwise_and", "bitwise_or", "bitwise_not",
    "bitwise_xor", "logical_and", "logical_or", "logical_not",
    "logical_xor", "exp", "log", "rsqrt", "sqrt", "tanh", "sigmoid",
    "maximum", "minimum", "clamp_min", "clamp_max", "abs", "neg", "sign",
    "sgn", "floor", "ceil", "round", "fill", "zero", "full", "zeros",
    "ones", "scalar_tensor", "pow", "remainder", "fmod", "clamp", "expm1",
    "log1p"})

_MATMUL = frozenset({"mm", "bmm", "addmm", "baddbmm", "mv", "addmv",
                     "dot"})
_GATHER = frozenset({"embedding", "index", "index_select", "gather"})
_SCATTER = frozenset({"index_put", "_index_put_impl", "index_add",
                      "scatter", "scatter_add", "scatter_reduce",
                      "index_copy"})
_FREE = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                   "new_empty_strided", "lift_fresh", "detach", "alias",
                   "_local_scalar_dense", "sym_size", "sym_stride",
                   "sym_numel", "sym_storage_offset", "is_same_size",
                   "resize_"})


def _kind(func) -> tuple:
    """(class, elementwise) of an op overload: class one of "free",
    "matmul", "conv", "conv_bwd", "gather", "scatter", "op"."""
    name = func.overloadpacket.__name__
    base = name[:-1] if name.endswith("_") and name != "_" else name
    if func.is_view or name in _FREE or base in _FREE:
        return "free", False
    if base in _MATMUL:
        return "matmul", False
    if base == "convolution":
        return "conv", False
    if base == "convolution_backward":
        return "conv_bwd", False
    if base in _GATHER:
        return "gather", False
    if base in _SCATTER:
        return "scatter", False
    return "op", base in ELEMENTWISE


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results (lists and tuples
    opened), appended to `out`."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    return out


def _prod(xs) -> int:
    p = 1
    for x in xs:
        p *= int(x)
    return p


def _matmul_flops(name: str, args) -> float:
    if name in ("mm", "bmm"):
        a, b = args[0], args[1]
    elif name in ("addmm", "baddbmm", "addmv"):
        a, b = args[1], args[2]
    elif name == "mv":
        a, b = args[0], args[1]
    else:                                   # dot
        return 2.0 * args[0].numel()
    m_k = _prod(a.shape)                    # (..., M, K) elements
    n = b.shape[-1] if b.dim() >= 2 and name not in ("mv", "addmv") else 1
    return 2.0 * m_k * n


def _conv_flops(out_numel: int, weight: torch.Tensor, transposed: bool,
                in_numel: int) -> float:
    per = _prod(weight.shape[1:])           # channels / groups x kernel
    return 2.0 * (in_numel if transposed else out_numel) * per


class OpStream(TorchDispatchMode):
    """Sums flops, bytes and live memory over every aten call made under
    it (module docstring); `kernels` holds each port kernel's recorded
    calls {"calls", "ops", "bytes"} by name, `ops` the count of aten calls
    and kernel ops, `off_meta` the results of compute ops that were not
    meta tensors (a host constant lifted in, `lift_fresh`, is free)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.hbm_bytes_fused = 0.0
        self.ops = 0
        self.off_meta = 0
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = 0
        self.peak = 0
        self._storages: Dict[int, int] = {}
        self._kinds: Dict[Any, tuple] = {}

    # -- live memory ---------------------------------------------------------
    def hold(self, t: torch.Tensor) -> int:
        """Count `t`'s storage live until it is freed; returns the bytes
        it added (0 for a storage already held)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return 0
        nb = st.nbytes()
        self._storages[key] = nb
        self.live += nb
        if self.live > self.peak:
            self.peak = self.live
        weakref.finalize(st, self._release, key)
        return nb

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # -- kernels -------------------------------------------------------------
    def kernel(self, name: str, cost: costs.Cost) -> None:
        """One port kernel's call on the meta device (`costs.record`)."""
        k = self.kernels.setdefault(name, {"calls": 0, "ops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["ops"] += cost.ops
        k["bytes"] += cost.bytes
        self.ops += 1
        self.hbm_bytes += cost.bytes
        self.hbm_bytes_fused += cost.bytes
        self.flops += cost.ops

    def __enter__(self):
        costs.add_listener(self.kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        costs.remove_listener(self.kernel)
        return super().__exit__(*exc)

    # -- the op stream -------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        kind = self._kinds.get(func)
        if kind is None:
            kind = self._kinds[func] = _kind(func)
        cls, elementwise = kind
        if cls == "free":
            return out
        results = _tensors(out, [])
        for t in results:
            if t.device.type != "meta":
                self.off_meta += 1
        for t in results:
            self.hold(t)
        name = func.overloadpacket.__name__.rstrip("_")
        if cls == "matmul":
            self.flops += _matmul_flops(name, args)
        elif cls == "conv":
            self.flops += _conv_flops(results[0].numel(), args[1],
                                      bool(args[6]), args[0].numel())
        elif cls == "conv_bwd":
            grad_out, inp, weight = args[0], args[1], args[2]
            mask = args[10] if len(args) > 10 else kwargs["output_mask"]
            per = _conv_flops(grad_out.numel(), weight, bool(args[7]),
                              inp.numel())
            self.flops += per * (int(mask[0]) + int(mask[1]))
        operands = _tensors(list(args) + list(kwargs.values()), [])
        if cls == "gather":
            idx = sum(_nbytes(t) for t in operands
                      if not t.is_floating_point() and t is not operands[0])
            nbytes = idx + 2 * sum(_nbytes(t) for t in results)
        elif cls == "scatter":
            # the indices and the updates read, the updated rows written
            nbytes = sum(_nbytes(t) for t in operands[1:]) \
                + _nbytes(operands[-1])
        else:
            nbytes = (sum(_nbytes(t) for t in operands)
                      + sum(_nbytes(t) for t in results))
        self.hbm_bytes += nbytes
        if not elementwise:
            self.hbm_bytes_fused += nbytes
        return out


def tree_tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_tensors(v)]
    return []


def unique_bytes(tensors) -> int:
    """Bytes of the distinct storages under `tensors`."""
    seen: Dict[int, int] = {}
    for t in tensors:
        st = t.untyped_storage()
        seen.setdefault(st._cdata, st.nbytes())
    return sum(seen.values())


def analyze(fn: Callable[[], Any], args) -> Dict[str, Any]:
    """Run `fn()` once under an `OpStream`, the tensors of `args` held as
    its arguments, and return {"flops", "hbm_bytes", "hbm_bytes_fused",
    "ops", "off_meta", "kernels", "argument_size_in_bytes",
    "output_size_in_bytes", "alias_size_in_bytes", "temp_size_in_bytes"}:
    temp is the peak of live bytes over the walk less the arguments;
    output counts the distinct storages of `fn`'s result, alias those of
    them that are arguments'."""
    arg_tensors = tree_tensors(args)
    stream = OpStream()
    arg_keys = set()
    arg_bytes = 0
    for t in arg_tensors:
        arg_bytes += stream.hold(t)
        arg_keys.add(t.untyped_storage()._cdata)
    with stream:
        out = fn()
    outs = tree_tensors(out)
    out_bytes = unique_bytes(outs)
    alias = unique_bytes([t for t in outs
                          if t.untyped_storage()._cdata in arg_keys])
    return {"flops": stream.flops, "hbm_bytes": stream.hbm_bytes,
            "hbm_bytes_fused": stream.hbm_bytes_fused, "ops": stream.ops,
            "off_meta": stream.off_meta, "kernels": stream.kernels,
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "alias_size_in_bytes": alias,
            "temp_size_in_bytes": stream.peak - arg_bytes}

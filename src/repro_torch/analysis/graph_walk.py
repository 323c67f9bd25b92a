"""Aten-graph recording and traversal shared by the port's cimcheck passes.

Counterpart of `repro/analysis/jaxpr_walk.py`.  Where the JAX package
walks the jaxpr of a traced function, the port walks the aten graph of a
callable run on real CPU tensors: one flat list of nodes whose
"call_function" nodes are aten operator overloads (`aten.mul.Tensor`,
`aten.floor.default`, ...), the graph `make_fx` records (`Node` has the
fields of a `torch.fx.Node` the passes read).  A scalar
operand survives as a literal argument (`aten.div.Tensor(v, 255.0)`), a
tensor made outside the trace as a `get_attr` constant, and the graph has
no nested scopes: autograd Functions, helper calls and `ste` all inline,
so a sink inside `ste_floor` sees its caller's arithmetic directly.

`trace` records with a `TorchDispatchMode` of its own rather than
`make_fx`: the ops seen and their operands are the same, but `make_fx`
snapshots every value into a fresh fake tensor and builds a
`torch.fx.Graph` (about 1.2 ms a node on one CPU core, against some
0.05 ms here), and refuses a Python-side read of a traced value
(`float(t)`, as the noise terms are read); the recorder keeps each
value's dtype and runs such reads as the eager path does.

  * `trace(fn, *args)` - the graph of `fn` under a lint trace, with
    `rounding_barrier` leaving its `aten.alias` marker and
    `quantization.lint_opaque` calls tagged or left out;
  * `op_name(node)` - the aten packet name ("mul", "floor", ...);
  * `inputs(node)` - the node operands of a node, in argument order;
  * `literal_value(graph, arg)` - the float of a literal operand, else
    None;
  * `is_float(arg)` / `is_pow2(x)` - dtype and value helpers;
  * `is_opaque(node)` - recorded inside a `lint_opaque` call (the port's
    copies of XLA's transcendentals);
  * `source_summary(node)` - a short location of a node.

Everything but `trace` reads graphs; nothing is re-traced.
"""
from __future__ import annotations

import contextlib
import math
import operator
import weakref
from typing import Any, Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree

# ops whose value is their (single) fill argument
_FILL_OPS = {"full": 1, "new_full": 2, "full_like": 1, "scalar_tensor": 0}


class Node:
    """One recorded value: a graph input ("placeholder"), a constant made
    outside the trace ("get_attr", named in `Graph.constants`) or
    an aten call ("call_function", `target` the op overload, `args` /
    `kwargs` with `Node`s for recorded operands) - the fields of a
    `torch.fx.Node` the passes read.  `meta["dtype"]` is the value's
    dtype; `meta["cimcheck_opaque"]` marks a `lint_opaque` call's node."""

    __slots__ = ("op", "target", "args", "kwargs", "meta", "name")

    def __init__(self, op: str, target, args=(), kwargs=None,
                 name: str = ""):
        self.op, self.target = op, target
        self.args, self.kwargs = args, kwargs or {}
        self.meta: Dict[str, Any] = {}
        self.name = name

    def __repr__(self):
        return f"Node({self.name})"


class Graph:
    """The recorded nodes in program order, and the constants the
    "get_attr" nodes name."""

    def __init__(self):
        self.nodes: List[Node] = []
        self.constants: Dict[str, torch.Tensor] = {}

    def add(self, op: str, target, args=(), kwargs=None) -> Node:
        node = Node(op, target, args, kwargs, f"n{len(self.nodes)}")
        self.nodes.append(node)
        return node


class _Recorder(TorchDispatchMode):
    """Records every aten call below autograd as a node of `graph`.
    Tensors are known by identity (weakly: a freed tensor cannot be an
    operand again); one the trace did not make is a constant."""

    def __init__(self):
        super().__init__()
        self.graph = Graph()
        self._nodes: Dict[int, tuple] = {}
        self._opaque = 0       # depth of recorded lint_opaque calls
        self._paused = 0       # depth of unrecorded lint_opaque calls

    def bind(self, t: torch.Tensor, node: Node) -> None:
        self._nodes[id(t)] = (weakref.ref(t), node)
        node.meta["dtype"] = t.dtype

    def node_of(self, a):
        """The node of an operand (nested lists and dicts mapped)."""
        if isinstance(a, torch.Tensor):
            hit = self._nodes.get(id(a))
            if hit is not None and hit[0]() is a:
                return hit[1]
            consts = self.graph.constants
            name = f"_tensor_constant{len(consts)}"
            consts[name] = a.detach().clone() if a.numel() == 1 else a
            node = self.graph.add("get_attr", name)
            self.bind(a, node)
            return node
        if isinstance(a, (list, tuple)):
            items = [self.node_of(b) for b in a]
            return type(a)(*items) if hasattr(a, "_fields") \
                else type(a)(items)
        if isinstance(a, dict):
            return {k: self.node_of(v) for k, v in a.items()}
        return a

    @contextlib.contextmanager
    def opaque(self, record: bool) -> Iterator[None]:
        attr = "_opaque" if record else "_paused"
        setattr(self, attr, getattr(self, attr) + 1)
        try:
            yield
        finally:
            setattr(self, attr, getattr(self, attr) - 1)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        node = self.graph.add("call_function", func, self.node_of(args),
                              self.node_of(kwargs))
        if self._opaque:
            node.meta["cimcheck_opaque"] = True
        if isinstance(out, torch.Tensor):
            self.bind(out, node)
        elif isinstance(out, (list, tuple)):
            for i, t in enumerate(out):
                if isinstance(t, torch.Tensor):
                    item = self.graph.add("call_function", operator.getitem,
                                          (node, i))
                    item.meta["cimcheck_opaque"] = bool(self._opaque)
                    self.bind(t, item)
        return out


@contextlib.contextmanager
def lint_trace(recorder) -> Iterator[None]:
    """Open a cimcheck trace: `rounding_barrier` returns `aten.alias(x)`
    (a node the recorder keeps) instead of `x`, and `lint_opaque` calls
    report to `recorder`, while it is open."""
    from repro_torch.core import quantization as q
    saved = q._LINT_TRACE
    q._LINT_TRACE = recorder
    try:
        yield
    finally:
        q._LINT_TRACE = saved


def trace(fn, *args, **kwargs) -> Graph:
    """The aten graph of ``fn(*args, **kwargs)`` run on the given tensors.

    Tensor leaves of `args` (nested in lists, tuples and dicts) become
    the graph's placeholders; every other leaf is passed as it is.
    Tracing executes `fn` once, eagerly, on real tensors."""
    rec = _Recorder()
    for i, leaf in enumerate(pytree.tree_leaves(args)):
        if isinstance(leaf, torch.Tensor):
            rec.bind(leaf, rec.graph.add("placeholder", f"arg{i}"))
    with lint_trace(rec), rec:
        out = fn(*args, **kwargs)
    rec.graph.add("output", "output", (rec.node_of(out),))
    return rec.graph


def op_name(node: Node) -> str:
    """The aten packet name of a call node ("mul" for aten.mul.Tensor),
    the function's name for a Python call, "" for other nodes."""
    if node.op != "call_function":
        return ""
    tgt = node.target
    packet = getattr(tgt, "overloadpacket", None)
    if packet is not None:
        return packet.__name__
    return getattr(tgt, "__name__", str(tgt))


def inputs(node: Node) -> List[Node]:
    """The node operands of `node` (args then kwargs, lists flattened)."""
    out: List[Node] = []

    def visit(a):
        if isinstance(a, Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            for b in a:
                visit(b)
    for a in node.args:
        visit(a)
    for a in node.kwargs.values():
        visit(a)
    return out


def literal_value(graph: Graph, arg: Any) -> Optional[float]:
    """The float of a literal operand: a Python number, a one-element
    constant tensor (`get_attr`, possibly through `lift_fresh_copy`), or a
    `full` / `new_full` / `full_like` / `scalar_tensor` of a number.
    None for a value computed from the inputs."""
    if isinstance(arg, bool):
        return None
    if isinstance(arg, (int, float)):
        return float(arg)
    if not isinstance(arg, Node):
        return None
    if arg.op == "get_attr":
        t = graph.constants.get(arg.target)
        if isinstance(t, torch.Tensor) and t.numel() == 1:
            return float(t.reshape(()).item())
        return None
    name = op_name(arg)
    if name in ("lift_fresh", "lift_fresh_copy", "clone", "_to_copy",
                "detach", "alias") and arg.args:
        return literal_value(graph, arg.args[0])
    if name in _FILL_OPS and len(arg.args) > _FILL_OPS[name]:
        fill = arg.args[_FILL_OPS[name]]
        return literal_value(graph, fill) if not isinstance(fill, Node) \
            else None
    return None


def is_float(arg: Any) -> bool:
    """True for a float-typed node or a Python float."""
    if isinstance(arg, float):
        return True
    if not isinstance(arg, Node):
        return False
    dtype = arg.meta.get("dtype")
    return dtype is not None and dtype.is_floating_point


def is_pow2(x: float) -> bool:
    """True for finite nonzero powers of two (incl. negative exponents)."""
    if x == 0.0 or not math.isfinite(x):
        return False
    m, _ = math.frexp(abs(x))
    return m == 0.5


def is_opaque(node: Node) -> bool:
    """Whether the node was recorded inside a `lint_opaque` call (a
    transcendental: one fresh value to the lint)."""
    return bool(node.meta.get("cimcheck_opaque"))


def source_summary(node: Node) -> str:
    """'file:line (fn)' of the node's innermost recorded frame where the
    trace kept a stack, else the node's name and operator."""
    st = node.meta.get("stack_trace")
    if st:
        for line in reversed(st.strip().splitlines()):
            line = line.strip()
            if line.startswith("File "):
                parts = [p.strip() for p in line.split(",")]
                fname = parts[0][len("File "):].strip('"').rsplit("/", 1)[-1]
                lineno = parts[1].removeprefix("line ") if len(parts) > 1 \
                    else "?"
                fn = parts[2].removeprefix("in ") if len(parts) > 2 else ""
                return f"{fname}:{lineno} ({fn})"
    return f"{node.name} = {op_name(node) or node.op}"

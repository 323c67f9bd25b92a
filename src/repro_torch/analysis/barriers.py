"""Numerics-barrier lint (pass id ``barriers``) over the port's aten graphs.

Counterpart of `repro/analysis/barriers.py`.  The integer contract of the
ADC epilogue and the quantizers: every float product that feeds a
``floor`` / ``round`` / ``ceil`` is rounded on its own before the sum that
follows it, and no divide by a constant turns into a multiply by its
reciprocal on that path.  Eager PyTorch runs each operator as its own
kernel, so on the host the contract holds by construction; what this pass
guards is the *source*: every such product stands behind
`rounding_barrier`, so a later fusion (a hand-written epilogue, a
compiled graph) has the barrier to respect, and every divisor on a
rounding path is a tensor (PyTorch's CUDA divide by a Python scalar or a
CPU scalar tensor multiplies by the reciprocal).

The walk starts at every float rounding sink of a graph recorded by
`graph_walk.trace` and goes backwards through value-preserving ops.  Its
codes are the JAX package's, plus one for aten ops the jaxpr has no
counterpart of:

  * **NB001** - an unbarriered ``mul`` reaches a rounding sink (the
    ``gain*dp`` pattern);
  * **NB002** - a ``div`` by a non-power-of-two literal (a Python scalar
    or a constant tensor) on such a path;
  * **NB003** - a contracting aten op on such a path: ``addcmul``,
    ``addcdiv``, ``lerp``, float ``addmm`` / ``baddbmm`` / ``addmv`` /
    ``addbmm`` / ``addr``, or ``add`` / ``sub`` with ``alpha != 1``.
    Each rounds a product and a sum once where the contract rounds them
    twice.

The barrier (`rounding_barrier`, an ``aten.alias`` node under a lint
trace), integer values and graph inputs stop the walk; so does a ``div``
by a computed tensor (a divide is an FMA boundary) and any op that makes
a fresh value (a matmul, a reduction, a transcendental).

What the graph cannot see: a kernel call is a ctypes call on raw
pointers, opaque to the trace.  `sass` checks the machine code the card
runs for the same contract (NB102).
"""
from __future__ import annotations

from typing import List, Optional


from repro_torch.analysis import graph_walk as gw
from repro_torch.analysis.graph_walk import Node
from repro_torch.analysis.findings import Finding, Report, Severity

PASS_ID = "barriers"

# rounding ops whose integer output depends on exact float bits
SINK_OPS = frozenset({"floor", "round", "ceil"})

# the barrier's marker under a lint trace
BARRIER_OPS = frozenset({"alias"})

# value-preserving ops the walk passes through (every float operand is
# followed; integer operands, such as indices, drop out)
TRANSPARENT_OPS = frozenset({
    "add", "sub", "neg", "maximum", "minimum", "clamp", "clamp_min",
    "clamp_max", "where", "expand", "view", "_unsafe_view", "reshape",
    "permute", "transpose", "t", "squeeze", "unsqueeze", "slice", "select",
    "index", "_unsafe_index", "index_select", "gather", "cat", "stack",
    "constant_pad_nd", "flip", "detach", "clone", "_to_copy", "contiguous",
    "lift_fresh", "lift_fresh_copy", "amax", "amin", "abs", "sign",
    "repeat", "narrow", "split", "split_with_sizes", "unbind", "getitem", "masked_fill",
    "expand_copy", "view_copy", "slice_copy", "select_copy",
})

# ops that contract a product into a sum (one rounding where the
# contract has two)
CONTRACTING_OPS = frozenset({"addcmul", "addcdiv", "lerp", "addmm",
                             "baddbmm", "addmv", "addbmm", "addr"})


class _Lint:
    """Backward-walk state over one graph."""

    def __init__(self, graph, where_prefix: str,
                 layer: Optional[int]):
        self.graph = graph
        self.where_prefix = where_prefix
        self.layer = layer
        self.findings: List[Finding] = []
        self._emitted: set = set()
        self._visited: set = set()

    def _emit(self, code: str, message: str, node: Node,
              sink_where: str) -> None:
        where = gw.source_summary(node)
        if sink_where and sink_where != where:
            where = f"{where} -> sink {sink_where}"
        if self.where_prefix:
            where = f"{self.where_prefix}: {where}"
        key = (code, message, where)
        if key in self._emitted:
            return
        self._emitted.add(key)
        self.findings.append(Finding(
            pass_id=PASS_ID, code=code, severity=Severity.ERROR,
            message=message, where=where, layer=self.layer))

    def scan(self) -> None:
        """Trace back from every float rounding sink of the graph."""
        for node in self.graph.nodes:
            if gw.op_name(node) in SINK_OPS and node.args \
                    and gw.is_float(node.args[0]) and not gw.is_opaque(node):
                self._trace(node.args[0], gw.source_summary(node))

    def _trace(self, start: Node, sink_where: str) -> None:
        work = [start]
        while work:
            v = work.pop()
            if not isinstance(v, Node) or not gw.is_float(v):
                continue
            if v in self._visited:
                continue
            self._visited.add(v)
            if v.op != "call_function" or gw.is_opaque(v):
                continue          # graph input, constant or opaque value
            name = gw.op_name(v)
            if name in BARRIER_OPS:
                continue
            if name in ("add", "sub") and v.kwargs.get("alpha", 1) != 1:
                self._emit(
                    "NB003",
                    f"aten.{name} with alpha={v.kwargs['alpha']!r} "
                    "contracts a product into a sum on a rounding path; "
                    "multiply, barrier, then add", v, sink_where)
                continue
            if name in TRANSPARENT_OPS:
                work.extend(gw.inputs(v))
                continue
            if name in CONTRACTING_OPS:
                self._emit(
                    "NB003",
                    f"aten.{name} rounds a product and a sum once on a "
                    "rounding path where the contract rounds them twice; "
                    "split it and wrap the product in rounding_barrier(...)",
                    v, sink_where)
                continue
            if name == "mul":
                lits = [gw.literal_value(self.graph, a) for a in v.args[:2]]
                pow2 = next((i for i, lv in enumerate(lits)
                             if lv is not None and gw.is_pow2(lv)), None)
                if pow2 is not None:
                    work.append(v.args[1 - pow2])
                    continue
                self._emit(
                    "NB001",
                    "unbarriered float product reaches a rounding op; wrap "
                    "the product in rounding_barrier(...) to pin it against "
                    "FMA contraction", v, sink_where)
                continue
            if name == "div":
                if v.kwargs.get("rounding_mode") is not None:
                    continue       # an integer-valued divide: a fresh value
                dlit = gw.literal_value(self.graph, v.args[1])
                if dlit is not None and not gw.is_pow2(dlit):
                    self._emit(
                        "NB002",
                        f"division by constant {dlit!r} reaches a rounding "
                        "op; PyTorch's CUDA divide by a scalar multiplies "
                        "by its reciprocal - divide by a tensor on the "
                        "operand's device, or use _static_reciprocal + "
                        "rounding_barrier", v, sink_where)
                    continue
                if dlit is not None:
                    work.append(v.args[0])
                continue   # computed divisor: div is itself an FMA boundary
            # anything else (matmuls, reductions, transcendentals, draws)
            # makes a fresh value: a safe stop


def lint_graph(graph: gw.Graph, *, where_prefix: str = "",
               layer: Optional[int] = None) -> List[Finding]:
    """Run the barrier lint over one recorded graph."""
    lint = _Lint(graph, where_prefix, layer)
    lint.scan()
    return lint.findings


def lint_callable(fn, *args, where_prefix: str = "", **kwargs) -> Report:
    """Trace ``fn(*args, **kwargs)`` on the given tensors and lint it."""
    report = Report()
    report.extend(lint_graph(gw.trace(fn, *args, **kwargs),
                             where_prefix=where_prefix))
    return report

"""The work a window did, counted from the network's own shapes: the
yardstick of the roofline and mfu readers.

Each engine-mode product is priced once per layer at the shape the
network calls it with (never per tile or per route), so the yardstick
reads the same whatever implements it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from bench.roofline import costs


@dataclasses.dataclass
class Work:
    """cim: (m, k, n, planes, beta_rows) -> calls; ops: products by
    rate ("int8" the CIM-mapped ones, "bf16", "f32")."""
    cim: Dict[Tuple[int, int, int, int, bool], int] = dataclasses.field(
        default_factory=dict)
    ops: Dict[str, float] = dataclasses.field(default_factory=dict)
    normals: float = 0.0

    def add_cim(self, m: int, k: int, n: int, r_in: int, beta_rows: bool,
                calls: int = 1) -> None:
        key = (int(m), int(k), int(n), costs.plane_count(r_in),
               bool(beta_rows))
        self.cim[key] = self.cim.get(key, 0) + calls
        self.add_ops("int8", 2.0 * m * k * n * calls)

    def add_ops(self, rate: str, ops: float) -> None:
        self.ops[rate] = self.ops.get(rate, 0.0) + float(ops)

    def cim_bound_s(self) -> float:
        """Least seconds of every cim_mbiw product of the window."""
        return sum(costs.bound_ms(costs.cim_mbiw(*key))[0] * calls
                   for key, calls in self.cim.items()) * 1e-3

    def peak_s(self) -> float:
        """Seconds every product of the window takes at its type's peak."""
        return sum(costs.ops_ms(ops, rate) for rate, ops in self.ops.items()
                   ) * 1e-3

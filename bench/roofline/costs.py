"""The work of the functions the benchmark prices, and the card's peaks.

A frozen copy of the port's cost table (`kernels/costs.py`) and of the
published H100 SXM peaks (`core/hw.H100_SXM`): a later change may edit the
program's copies, never the yardstick.  A formula counts what the
*function* needs, whatever implements it: each input byte read once, each
output byte written once, and the operations of its products (2 a
multiply-add) at the rate of their type.

Host arithmetic over shapes: nothing here touches a device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    """Published peaks of one NVIDIA card (dense rates, no sparsity, at
    the full power limit)."""
    name: str
    int8_ops: float          # op/s, int8 tensor cores
    bf16_flops: float        # FLOP/s, bf16 tensor cores
    f32_flops: float         # FLOP/s, float32 outside the tensor cores
    hbm_bw: float            # byte/s


# NVIDIA's H100 SXM data sheet (700 W): dense rates without sparsity.
H100_SXM = GPUSpec(name="h100_sxm", int8_ops=1979e12, bf16_flops=989e12,
                   f32_flops=67e12, hbm_bw=3.35e12)


@dataclasses.dataclass(frozen=True)
class Cost:
    """One call's work: `ops` operations of its products (2 a
    multiply-add) at the rate named by `rate` (a key of `rates`; None
    where the function has no products), and `bytes` moved."""
    ops: float
    bytes: float
    rate: Optional[str]


def rates(card: GPUSpec = H100_SXM) -> dict:
    """The card's peak rate of each operation type, a second."""
    return {"int8": card.int8_ops, "bf16": card.bf16_flops,
            "f32": card.f32_flops}


def bound_ms(cost: Cost, card: GPUSpec = H100_SXM) -> Tuple[float, str]:
    """The least time (ms) the card could take for `cost` and what bounds
    it: the larger of its operations over their type's peak and its bytes
    over the memory rate."""
    t_ops = 0.0 if cost.rate is None else cost.ops / rates(card)[cost.rate]
    t_bytes = cost.bytes / card.hbm_bw
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def ops_ms(ops: float, rate: str, card: GPUSpec = H100_SXM) -> float:
    """Milliseconds `ops` operations take at the peak of type `rate`."""
    return 1e3 * ops / rates(card)[rate]


def plane_count(r_in: int) -> int:
    """Input planes of the input-serial walk at r_in: bit-serial below 3b,
    nibble-serial at 3-8b."""
    if not 1 <= r_in <= 8:
        raise ValueError(f"r_in={r_in} outside the macro's 1-8b range")
    shift = 1 if r_in <= 2 else 4
    return -(-r_in // shift)


def cim_mbiw(m: int, k: int, n: int, planes: int, beta_rows: bool) -> Cost:
    """The input-serial int8 matmul on x planes (M, P*K) int8, w (K, N)
    int8, gamma (1, N) and beta (1, N) or (M, N) float32, giving (M, N)
    int32: 2*M*N*K*P int8 operations."""
    return Cost(ops=2.0 * m * n * k * planes,
                bytes=(m * planes * k + k * n + 4 * n
                       + 4 * n * (m if beta_rows else 1) + 4 * m * n),
                rate="int8")


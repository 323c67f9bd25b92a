"""The work of the function each port kernel computes: one table of cost
formulas.

A formula counts what the *function* needs, whatever implements it:
each input byte read once, each output byte written once, and the
operations of its products (2 a multiply-add) at the rate of their type.
The plain version's step-by-step arithmetic and a kernel's own tiling
are not counted.  Where the work depends on the data (the pairs a causal
or windowed mask keeps), the formula takes what decides it and counts
what this call needs.

Three readers share the table: the kernels' `meta`-device routes, which
record one op with this cost in place of a launch
(`launch/trace_analysis.py` sums them into a dry run's `flops` and
`hbm_bytes`); `chip_smoke.py`, whose `bound_ms` of every kernel is
`bound_ms(cost)` here; and `PERF.md` §6's Bound column, which names the
formula of each row.

  * `cim_mbiw(m, k, n, planes, beta_rows)` - the input-serial int8
    matmul over `planes` input planes with the fused ADC epilogue;
  * `ring_decode(r, l, h, hd)` - one query a row over its (L, H, hd)
    float32 ring;
  * `flash(kind, b, h, g, sq, sk, d, causal, window, elt, q_off)` - the
    flash forward ("fwd"), dq ("dq") or dk/dv ("dkv");
  * `threefry_normal(streams, n)` - the draw: bytes only;
  * `bound_ms(cost)` - the least time on a card and what bounds it.

Host arithmetic over shapes: nothing here touches a device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np

from repro_torch.core.hw import H100_SXM, GPUSpec


@dataclasses.dataclass(frozen=True)
class Cost:
    """One call's work: `ops` operations of its products (2 a
    multiply-add) at the rate named by `rate` (a key of `rates`; None
    where the function has no products), and `bytes` moved (each input
    read once, each output written once)."""
    ops: float
    bytes: float
    rate: Optional[str]


def rates(card: GPUSpec = H100_SXM) -> dict:
    """The card's peak rate of each operation type, a second: int8 and
    bf16 on the tensor cores and float32 outside them."""
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


def cim_mbiw(m: int, k: int, n: int, planes: int, beta_rows: bool) -> Cost:
    """`cim_mbiw_matmul_planes` on x_planes (M, P*K) int8, w_q (K, N)
    int8, gamma (1, N) and beta (1, N) or (M, N) float32, giving (M, N)
    int32: 2*M*N*K*P int8 operations."""
    return Cost(ops=2.0 * m * n * k * planes,
                bytes=(m * planes * k + k * n + 4 * n
                       + 4 * n * (m if beta_rows else 1) + 4 * m * n),
                rate="int8")


def ring_decode(r: int, l: int, h: int, hd: int) -> Cost:
    """`ring_decode` on q (R, H, hd), k / v (R, L, H, hd) and bias (R, L)
    float32, giving (R, H, hd): the two products, 4*R*H*L*hd float32
    operations."""
    return Cost(ops=4.0 * r * h * l * hd,
                bytes=4 * (2 * r * l * h * hd + 2 * r * h * hd + r * l),
                rate="f32")


def flash_kept_pairs(sq: int, sk: int, causal: bool, window: int,
                     q_off: int = 0) -> int:
    """(query, key) pairs the mask keeps, per (batch, head): query row i
    sits at position q_off + i and sees keys up to it (causal) and no
    further back than window - 1 (window > 0)."""
    qp = q_off + np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk - 1, qp) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, qp - window + 1) if window > 0 else np.zeros(sq)
    return int(np.maximum(0, hi - lo + 1).sum())


def flash(kind: str, b: int, h: int, g: int, sq: int, sk: int, d: int,
          causal: bool, window: int, elt: int, q_off: int = 0) -> Cost:
    """A flash kernel on q (B, H, Sq, D), k / v (B, G, Sk, D) of `elt`
    bytes an element: the products over the kept pairs (forward 2, dq 3,
    dk/dv 4 products of 2*D operations a pair) at the bf16 tensor-core
    rate; bytes: q, k, v (and dO) read, O or the gradients written, lse
    and delta float32, dq and dk / dv float32."""
    pairs = b * h * flash_kept_pairs(sq, sk, causal, window, q_off)
    ops = {"fwd": 2, "dq": 3, "dkv": 4}[kind] * 2.0 * d * pairs
    qb, kb = b * h * sq * d, b * g * sk * d
    if kind == "fwd":
        nbytes = elt * (2 * qb + 2 * kb) + 4 * b * h * sq
    elif kind == "dq":
        nbytes = elt * (2 * qb + 2 * kb) + 8 * b * h * sq + 4 * qb
    else:
        nbytes = elt * (2 * qb + 2 * kb) + 8 * b * h * sq \
            + 8 * b * h * sk * d
    return Cost(ops=ops, bytes=nbytes, rate="bf16")


def threefry_normal(streams: int, n: int) -> Cost:
    """`threefry_normal` drawing n float32 normals under each of
    `streams` (S, 2) int64 keys: the keys read (16 bytes a stream) and the
    normals written.  The draw has no products, so no operations: the
    instructions that bound it on a card are counted from the kernel's
    own SASS (chip_smoke's `draw_trip_of` / `draw_bound_ms`)."""
    return Cost(ops=0.0, bytes=16 * streams + 4 * streams * n, rate=None)


# -- the meta-device routes' record --------------------------------------

_LISTENERS: List[Callable[[str, Cost], None]] = []


def add_listener(fn: Callable[[str, Cost], None]) -> None:
    """Call `fn(name, cost)` for every kernel op recorded on the meta
    device until `remove_listener(fn)`."""
    _LISTENERS.append(fn)


def remove_listener(fn: Callable[[str, Cost], None]) -> None:
    _LISTENERS.remove(fn)


def record(name: str, cost: Cost) -> None:
    """One kernel call on the meta device: the listeners (a dry run's
    analysis) take it as one op of `cost`.  With no listener it is
    dropped: a meta tensor carries no data to compute."""
    for fn in list(_LISTENERS):
        fn(name, cost)

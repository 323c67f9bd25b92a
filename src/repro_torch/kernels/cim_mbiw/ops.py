"""Public wrappers around the cim_mbiw kernel.

Counterpart of `repro/kernels/cim_mbiw/ops.py`.  Handles what the kernel
does not: plane decomposition of unsigned inputs (bit-serial at 1-2b,
nibble-serial at 3-8b), the macro's K<=1152 row-tiling with per-tile ADC
conversion, and dequantization back to dp units.  The Hopper kernel masks
ragged M/N/K edges itself, so nothing here pads.

Precision dispatch
------------------
`KernelPrecision` names one of the macro's operating points (r_in, r_w,
r_out); `kernel_variant` returns a callable specialized to that point
(plane walk + accumulator shift from r_in, ADC epilogue from r_out) and
caches it.  `kernel_variant_for_tile` clamps the preferred block sizes to
one dispatched tile, exactly as the JAX package does, and keys the cache
on them; on the card those Pallas blocks change no launch.  What the
schedule tunes here is the Hopper route's tile: `kernel_variant_for_tile
(..., tile=)` hands a tuned `(route, bm, bn, kc)` tile to
`cim_mbiw_matmul_planes`, which runs it wherever the dispatch takes that
route (`kernel.route_for`), and `block_candidates` lists the tiles a
dispatch may take (`kernel.legal_tiles`).

Units: inputs/weights are integer codes (unsigned < 2^r_in / odd ints in
+/-(2^r_w - 1)); outputs are int32 ADC codes in [0, 2^r_out) - or raw
int32 dp with `fuse_adc=False`; gamma/beta are the per-channel ABN gain
and offset (ADC code units); `g0` is the unity-gain code gain.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import torch

from repro_torch.core import digital_ref
from repro_torch.core.hw import CIMMacroConfig, DEFAULT_MACRO
from repro_torch.kernels.cim_mbiw.kernel import (Tile, cim_mbiw_matmul_planes,
                                                 legal_tiles, plane_layout)

_PLANE_SHIFT = 4  # legacy nibble-plane default (r_in > 7 inputs)

SUPPORTED_R_IN = (1, 2, 3, 4, 5, 6, 7, 8)
SUPPORTED_R_W = (1, 2, 3, 4)
SUPPORTED_R_OUT = (1, 2, 3, 4, 5, 6, 7, 8)


@dataclasses.dataclass(frozen=True)
class KernelPrecision:
    """One (r_in, r_w, r_out) operating point of the macro."""
    r_in: int = 8
    r_w: int = 4
    r_out: int = 8

    def __post_init__(self):
        if self.r_in not in SUPPORTED_R_IN:
            raise ValueError(f"r_in={self.r_in} not in {SUPPORTED_R_IN}")
        if self.r_w not in SUPPORTED_R_W:
            raise ValueError(f"r_w={self.r_w} not in {SUPPORTED_R_W}")
        if self.r_out not in SUPPORTED_R_OUT:
            raise ValueError(f"r_out={self.r_out} not in {SUPPORTED_R_OUT}")

    @property
    def plane_shift(self) -> int:
        """Bits per input plane of the serial walk (1 bit-serial at
        r_in <= 2, 4 nibble-serial above)."""
        return plane_layout(self.r_in)[0]

    @property
    def n_planes(self) -> int:
        """Number of input planes the kernel walks (ceil(r_in/shift))."""
        return plane_layout(self.r_in)[1]


def split_planes(x_q: torch.Tensor, r_in: int,
                 plane_shift: Optional[int] = None
                 ) -> Tuple[torch.Tensor, int]:
    """Unsigned ints < 2^r_in -> plane-major int8 layout (M, P*K).

    With `plane_shift=None` (legacy): a single plane whenever the values fit
    in int8 (r_in <= 7), nibble planes above.  With an explicit shift the
    decomposition is ceil(r_in / shift) planes of `shift` bits each - the
    precision-specialized walk of `KernelPrecision`.
    """
    x = x_q.to(torch.int32)
    if plane_shift is None:
        if r_in <= 7:
            return x.to(torch.int8), 1
        plane_shift = _PLANE_SHIFT
    n_planes = -(-r_in // plane_shift)
    if n_planes == 1:
        return x.to(torch.int8), 1
    mask = 2**plane_shift - 1
    planes = [((x >> (plane_shift * p)) & mask).to(torch.int8)
              for p in range(n_planes)]
    return torch.cat(planes, dim=-1), n_planes


def _clamp_block(pref: int, dim: int, align: int = 8) -> int:
    """Largest useful block for `dim`: `pref` capped at dim rounded up to
    `align`."""
    return max(align, min(pref, -(-dim // align) * align))


def block_candidates(rows: int, k: int, n: int,
                     planes: int) -> Tuple[Tile, ...]:
    """The tiles one dispatched tile of GEMM shape (rows, k) x (k, n) over
    `planes` input planes may run: every legal tile of the route the shape
    takes (`kernel.legal_tiles`), the schedule tuner's search space."""
    return legal_tiles(rows, n, k, planes)


def kernel_variant(prec: KernelPrecision, bm: int = 256, bn: int = 256,
                   bk: int = 512, fuse_adc: bool = True,
                   tile: Optional[Tile] = None) -> Callable:
    """Precision-specialized kernel callable (cached per operating point).

    Returned fn: (x_q (M,K) uint<2^r_in, w_q (K,N) odd ints, gamma (N,),
    beta (N,) or (M,N), g0) -> (M,N) int32 ADC codes.  With
    `fuse_adc=False` the fn returns the raw int32 dp instead.  The cache
    is keyed on the (plane_shift, n_planes) input walk and the r_out
    epilogue, so operating points differing only in r_w (weights arrive
    pre-decoded) or sharing a plane layout (e.g. r_in 5-8) share one
    variant.  `tile` (a tuned route tile, or None) is part of the key and
    reaches every launch of the variant.
    """
    shift, n_planes = plane_layout(prec.r_in)
    return _kernel_variant(shift, n_planes, prec.r_out, bm, bn, bk,
                           fuse_adc, tile)


def kernel_variant_for_tile(prec: KernelPrecision, rows: int, k: int, n: int,
                            *, bm: int = 256, bn: int = 256, bk: int = 512,
                            fuse_adc: bool = True,
                            tile: Optional[Tile] = None) -> Callable:
    """Kernel variant fitted to one dispatched tile's geometry: the
    preferred (maximum) block sizes clamped per dimension to the tile's
    (rows, k, n), and the tuned route tile `tile` (None: the shape's
    own).  Numerically identical at any block size and tile."""
    return kernel_variant(prec, bm=_clamp_block(bm, rows),
                          bn=_clamp_block(bn, n), bk=_clamp_block(bk, k),
                          fuse_adc=fuse_adc, tile=tile)


@functools.lru_cache(maxsize=None)
def _kernel_variant(shift: int, n_planes: int, r_out: int, bm: int, bn: int,
                    bk: int, fuse_adc: bool,
                    tile: Optional[Tile]) -> Callable:
    r_eff = shift * n_planes          # widest r_in with this plane layout

    def run(x_q, w_q, gamma, beta, g0: float):
        return cim_matmul(x_q, w_q, gamma, beta, r_in=r_eff, r_out=r_out,
                          g0=g0, plane_shift=shift, fuse_adc=fuse_adc,
                          tile=tile)

    def on_planes(x_planes, w_q, gamma, beta, g0: float):
        return cim_matmul_planes(x_planes, w_q, gamma, beta, r_out=r_out,
                                 g0=g0, plane_shift=shift,
                                 fuse_adc=fuse_adc, tile=tile)
    run.split = lambda x_q: split_planes(x_q, r_eff, shift)[0].contiguous()
    run.on_planes = on_planes
    run.plane_shift = shift
    run.n_planes = n_planes
    run.blocks = (bm, bn, bk)
    run.tile = tile
    return run


def cim_matmul(x_q: torch.Tensor, w_q: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor, *, r_in: int, r_out: int, g0: float,
               plane_shift: Optional[int] = None,
               fuse_adc: bool = True,
               tile: Optional[Tile] = None) -> torch.Tensor:
    """One macro row-tile (K <= n_rows recommended): int inputs -> ADC codes.

    x_q: (M, K) unsigned ints < 2^r_in; w_q: (K, N) odd ints; gamma (N,);
    beta (N,) - or (M, N) for a per-GEMM-row offset; `tile` a tuned route
    tile (None: the shape's own).
    Returns (M, N) int32 codes (raw int32 dp when `fuse_adc=False`).
    """
    x_planes, _ = split_planes(x_q, r_in, plane_shift)
    shift = _PLANE_SHIFT if plane_shift is None else plane_shift
    return cim_matmul_planes(x_planes, w_q, gamma, beta, r_out=r_out, g0=g0,
                             plane_shift=shift, fuse_adc=fuse_adc, tile=tile)


def cim_matmul_planes(x_planes: torch.Tensor, w_q: torch.Tensor,
                      gamma: torch.Tensor, beta: torch.Tensor, *,
                      r_out: int, g0: float, plane_shift: int,
                      fuse_adc: bool = True,
                      tile: Optional[Tile] = None) -> torch.Tensor:
    """cim_matmul past the plane split: x_planes (M, P*K) int8 as
    split_planes lays them out, so that the column tiles of one macro
    row tile share one split."""
    m = x_planes.shape[0]
    gamma2 = gamma.reshape(1, -1).to(torch.float32).contiguous()
    if beta.dim() == 2 and beta.shape[0] == m and m != 1:
        beta2 = beta.to(torch.float32).contiguous()
    else:
        beta2 = beta.reshape(1, -1).to(torch.float32).contiguous()
    return cim_mbiw_matmul_planes(
        x_planes.contiguous(), w_q.to(torch.int8).contiguous(), gamma2,
        beta2, plane_shift=plane_shift, g0=g0, r_out=r_out,
        fuse_adc=fuse_adc, tile=tile)


def cim_linear(x_q: torch.Tensor, w_q: torch.Tensor, gamma: torch.Tensor,
               beta: torch.Tensor, *, r_in: int, r_w: int, r_out: int,
               cfg: CIMMacroConfig = DEFAULT_MACRO,
               adaptive_swing: bool = True) -> torch.Tensor:
    """Full layer: row-tiled kernel calls with per-tile ADC, digital
    partial-sum recombination in dp units (host side, like the chip).

    Returns (M, N) float32 dp_hat (caller applies act/weight scales)."""
    m, k_dim = x_q.shape
    n = w_q.shape[1]
    n_rows = cfg.n_rows
    if adaptive_swing:
        units = cfg.units_for_rows(min(k_dim, n_rows))
    else:
        units = cfg.n_units
    n_dp = units * cfg.rows_per_unit
    g0 = digital_ref.adc_gain_factor(r_in, r_w, r_out, n_dp,
                                     cfg.swing_efficiency(units),
                                     cfg.alpha_adc())
    mid = 2.0 ** (r_out - 1)
    g0_t = torch.tensor(g0, dtype=torch.float32, device=x_q.device)
    gain = gamma[None, :] * g0_t
    dp_hat = torch.zeros((m, n), dtype=torch.float32, device=x_q.device)
    for t in range(-(-k_dim // n_rows)):
        ks, ke = t * n_rows, min((t + 1) * n_rows, k_dim)
        codes = cim_matmul(x_q[:, ks:ke], w_q[ks:ke], gamma, beta,
                           r_in=r_in, r_out=r_out, g0=g0)
        dp_hat = dp_hat + (codes.to(torch.float32) + 0.5 - mid
                           - beta[None, :]) / gain
    return dp_hat

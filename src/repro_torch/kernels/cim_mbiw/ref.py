"""Plain PyTorch versions of the cim_mbiw kernel.

Counterpart of `repro/kernels/cim_mbiw/ref.py`.  Semantics: one macro
row-tile (K <= 1152) of the digital-equivalent CIM matmul, ADC conversion
fused in the epilogue:

    code[m, n] = clip( floor( 2^(r_out-1)
                              + gamma[n] * g0 * sum_k x[m,k] * w[k,n]
                              + beta[n] ),  0, 2^r_out - 1 )

x: unsigned ints < 2^r_in, w: odd ints in +/-(2^r_w - 1), g0 the unity-gain
code gain of digital_ref.adc_gain_factor.

  * `cim_mbiw_matmul_planes_ref` - the kernel's own signature (plane-major
    int8 input planes); the CPU path of the kernel wrapper and the
    yardstick the CUDA kernel is held to on the card.
  * `cim_matmul_ref`        - direct integer matmul + epilogue (any r).
  * `cim_matmul_ref_serial` - the literal per-precision datapath: input
    planes at the precision's serial layout, weight bits combined
    spatially at 2^p column weights.

The epilogue keeps the fixed float order of the contract: gain =
f32(gamma * f32(g0)), t = f32(gain * f32(dp)), code = floor((mid + t) +
beta).  Eager PyTorch runs each of those as its own rounded operation.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core import digital_ref
from repro_torch.core.digital_ref import int_matmul
from repro_torch.core.quantization import rounding_barrier
from repro_torch.kernels.cim_mbiw.kernel import plane_layout


def _adc_epilogue(dp: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  g0: float, r_out: int) -> torch.Tensor:
    """int32 dp (M, N) -> int32 ADC codes.  gamma is (N,) or (1, N); beta
    (N,), (1, N) or (M, N) (a per-GEMM-row offset broadcasts the same)."""
    gamma_b = gamma.reshape(1, -1)
    beta_b = beta if beta.dim() >= 2 else beta[None, :]
    mid = 2.0 ** (r_out - 1)
    # g0 rounds to f32 first, as JAX's weak-typed Python scalar does
    g0_t = torch.tensor(g0, dtype=torch.float32, device=gamma.device)
    # barriered as the JAX package's oracle and the kernel's epilogue
    gain = rounding_barrier(gamma_b * g0_t)
    t = rounding_barrier(gain * dp.to(torch.float32))
    code = torch.floor((mid + t) + beta_b)
    return torch.clamp(code, 0.0, 2.0 ** r_out - 1.0).to(torch.int32)


def cim_mbiw_matmul_planes_ref(x_planes: torch.Tensor, w_q: torch.Tensor,
                               gamma: torch.Tensor, beta: torch.Tensor, *,
                               plane_shift: int, g0: float, r_out: int,
                               fuse_adc: bool = True) -> torch.Tensor:
    """The kernel's function, written plainly.

    x_planes: (M, P*K) int8, P planes laid out plane-major along the last
    axis; w_q: (K, N) int8; gamma (1, N) f32; beta (1, N) or (M, N) f32.
    Returns (M, N) int32 ADC codes, or the raw int32 dp with
    `fuse_adc=False`:  dp = sum_p 2^(plane_shift*p) * (x_p @ w)."""
    m, pk = x_planes.shape
    k_dim, n = w_q.shape
    if pk % k_dim:
        raise ValueError(f"x_planes width {pk} is not a multiple of K={k_dim}")
    dp = torch.zeros((m, n), dtype=torch.int32, device=x_planes.device)
    for p in range(pk // k_dim):
        part = int_matmul(x_planes[:, p * k_dim:(p + 1) * k_dim], w_q)
        dp = dp + part * (1 << (plane_shift * p))
    if not fuse_adc:
        return dp
    return _adc_epilogue(dp, gamma, beta, g0, r_out)


def fma_canary(seed: int = 0, m: int = 64, k: int = 144, n: int = 64,
               r_out: int = 8) -> Dict[str, np.ndarray]:
    """Seeded inputs on which a fused multiply-add in the ADC epilogue
    gives other codes than the contract's rounded chain.

    A compiler that contracts `mid + gain*dp` into fma(gain, dp, mid)
    rounds the sum once where the contract rounds the product first.  The
    search draws 8b inputs and 4b weights, finds per column a row where the
    two roundings of mid + gain*dp differ by one ulp, and sets that
    column's beta so the two land on either side of an integer.  Returns
    x (M, K) int32, w (K, N) int32 odd, gamma/beta (N,) float32, g0, r_out,
    and the codes of both chains: `codes` (the contract) and `codes_fma`.
    The two differ in at least half of the columns."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.integers(0, 256, size=(m, k)).astype(np.int32)
    w = (2 * rng.integers(-8, 8, size=(k, n)) + 1).astype(np.int32)
    gamma = (2.0 ** rng.uniform(0.0, 5.0, size=n)).astype(f32)
    g0 = digital_ref.adc_gain_factor(8, 4, r_out, 144)
    mid = f32(2.0 ** (r_out - 1))
    dp = x.astype(np.int64) @ w.astype(np.int64)
    gain = gamma * f32(g0)                         # f32 product
    p64 = gain.astype(np.float64) * dp             # exact: 24 x 24 bits
    s_chain = mid + p64.astype(f32)                # rounded product, sum
    # a single rounding of the exact sum; float64 holds that sum exactly
    # when |p| >= mid/16 (at most 53 significant bits), so only such
    # elements are candidates
    s_fma = (p64 + float(mid)).astype(f32)
    cand = (s_fma != s_chain) & (np.abs(p64) >= float(mid) / 16)
    beta = np.zeros(n, f32)
    for j in range(n):
        rows = np.flatnonzero(cand[:, j])
        if rows.size:
            hi = max(s_chain[rows[0], j], s_fma[rows[0], j])
            beta[j] = f32(np.ceil(hi)) - hi         # exact (Sterbenz)
    top = f32(2.0 ** r_out - 1)
    codes = np.clip(np.floor(s_chain + beta), 0, top).astype(np.int32)
    s_fma = np.where(np.abs(p64) >= float(mid) / 16, s_fma, s_chain)
    codes_fma = np.clip(np.floor(s_fma + beta), 0, top).astype(np.int32)
    flipped = int(np.sum(np.any(codes != codes_fma, axis=0)))
    if 2 * flipped < n:
        raise RuntimeError(f"canary seed {seed} flips only {flipped} of "
                           f"{n} columns")
    return dict(x=x, w=w, gamma=gamma, beta=beta, g0=g0, r_out=r_out,
                codes=codes, codes_fma=codes_fma)


def cim_matmul_ref(x_q: torch.Tensor, w_q: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, *, g0: float, r_out: int
                   ) -> torch.Tensor:
    """Direct oracle: integer matmul of the unsplit codes + ADC epilogue."""
    return _adc_epilogue(int_matmul(x_q, w_q), gamma, beta, g0, r_out)


def cim_matmul_ref_serial(x_q: torch.Tensor, w_q: torch.Tensor,
                          gamma: torch.Tensor, beta: torch.Tensor, *,
                          r_in: int, r_w: int, r_out: int, g0: float
                          ) -> torch.Tensor:
    """Per-precision serial walk:
        dp = sum_p 2^(shift*p) * sum_b 2^b * (plane_p(x) . S_b(w))
    with plane_p the precision's input plane slices and S_b the +/-1 weight
    bit-planes (weight-parallel column combination)."""
    shift, n_planes = plane_layout(r_in)
    x = x_q.to(torch.int32)
    mask = 2**shift - 1
    w_planes = digital_ref.encode_weight_planes(w_q.to(torch.int32), r_w)
    dp = torch.zeros(x.shape[:-1] + (w_q.shape[-1],), dtype=torch.int32,
                     device=x.device)
    for p in range(n_planes):
        xp = (x >> (shift * p)) & mask
        per_plane = torch.zeros_like(dp)
        for b in range(r_w):
            per_plane = per_plane + (2**b) * int_matmul(xp, w_planes[b])
        dp = dp + (2 ** (shift * p)) * per_plane
    return _adc_epilogue(dp, gamma, beta, g0, r_out)

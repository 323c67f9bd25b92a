// flash_common.cuh - what the flash forward and backward kernels share:
// the tile shape, the thread layout, input conversion and the keep-mask.
//
// Layout.  Every operand is read through element strides (batch, sequence,
// head), with the head dimension contiguous, so q/k/v pass in the model's
// (B, S, H, D) order and the kernels index them as (B, H, S, D) without a
// transpose.  A tile lives in shared memory as float32 rows of D + 1
// values: the odd row length puts neighbouring rows on neighbouring banks,
// so both row-wise reads (q . k over d) and column-wise reads (p . v over
// the keys) are free of bank conflicts.
//
// Threads.  256 threads as a 16 x 16 grid (ty, tx).  A thread owns the
// rows ty + 16 i (i < 4) of a 64-row tile, and either the columns
// tx + 16 j (j < 4, or j < 2 for a 32-column tile) of a score tile or the
// output dimensions tx + 16 j (j < D / 16).  The 16 threads of a row sit
// in one half-warp, so a row's max and sum are xor-shuffles over offsets
// 8, 4, 2, 1; every lane of the row ends with the same value (each step
// adds the same pair).
//
// Head-dimension bounds.  Each kernel is a template on the bound MAXD of
// the head dimension it holds in registers (DJ = MAXD / 16 values a thread
// per output row), compiled twice: MAXD 128 for D <= 128, with the tiles it
// has always had, and MAXD 256 for 128 < D <= 256.  At MAXD 256 the float32
// tiles of the backward outgrow the 227 KB a block can opt in to, so dq
// walks 32-row key tiles and dk/dv 32-row query tiles there (the forward
// keeps 64 x 64: 209 KB).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16
constexpr int MAX_D_SMALL = 128;  // the first bound: D <= 128
constexpr int MAX_D = 256;        // the largest head dimension taken
constexpr float NEG_INF = -1e30f;  // the masked score, as in the JAX kernel

enum DType { F32 = 0, BF16 = 1 };

// element strides of one (B, S, H, D) operand; D is contiguous
struct Strides {
  long long b, s, h;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// the JAX kernel's _mask, positions global: keys past Sk never reach it
__device__ __forceinline__ bool keep(int qp, int kp, int causal,
                                     int window) {
  bool k = !causal || qp >= kp;
  if (window > 0) k = k && (qp - kp) < window;
  return k;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// rows [r0, r0 + rows) of one (b, h) slice into a float tile of ld = D + 1,
// times `mul`; rows past `limit` are zero
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          Strides st, int b, int h, int r0,
                                          int rows, int limit, int D,
                                          float mul) {
  const int ld = D + 1;
  const T* base = src + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < rows * D; idx += THREADS) {
    const int r = idx / D, d = idx - (idx / D) * D;
    float v = 0.0f;
    if (r0 + r < limit) v = to_f(base[(long long)(r0 + r) * st.s + d]) * mul;
    dst[r * ld + d] = v;
  }
}

__host__ __device__ inline int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

}  // namespace flash

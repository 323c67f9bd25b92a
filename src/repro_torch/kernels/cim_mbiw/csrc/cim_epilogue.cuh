// cim_epilogue.cuh - the DSCI-ADC + ABN epilogue that every cim_mbiw route
// (cim_mbiw.cu, cim_mbiw_tc.cu, cim_mbiw_splitk.cu) applies to its int32
// dot product, and the plane combination.
//
//   code = clip(floor((mid + f32(f32(gamma * g0) * f32(dp))) + beta),
//               0, 2^r_out - 1)
//
// Every step rounds on its own (__fmul_rn, __fadd_rn) in the contract's
// order.  A fused multiply-add of gain * dp into mid rounds once where the
// contract rounds twice and flips codes at floor boundaries; the _rn
// intrinsics are never contracted, and the sources are built without
// --use_fast_math.

#pragma once

#include <stdint.h>

namespace cim {

// the epilogue's constants for one call
struct Adc {
  float g0, mid, top;
  int fuse_adc;  // 0: store the raw dp
};

__host__ __device__ inline Adc make_adc(float g0, int r_out,
                                       int fuse_adc) {
  return Adc{g0, (float)(1 << (r_out - 1)), (float)((1 << r_out) - 1),
             fuse_adc};
}

// the value stored at one output element for a dot product dp
__device__ __forceinline__ int32_t adc_code(const Adc& a, int32_t dp,
                                            float gamma, float beta) {
  if (!a.fuse_adc) return dp;
  const float gain = __fmul_rn(gamma, a.g0);
  const float t = __fmul_rn(gain, __int2float_rn(dp));
  float code = floorf(__fadd_rn(__fadd_rn(a.mid, t), beta));
  code = fminf(fmaxf(code, 0.0f), a.top);
  return (int32_t)code;
}

// beta of element (row, col): per column (1, N) or per GEMM row (M, N)
__device__ __forceinline__ float beta_at(const float* __restrict__ beta,
                                         int beta_rows, int row, int col,
                                         int N) {
  return beta_rows ? beta[(size_t)row * N + col] : beta[col];
}

}  // namespace cim

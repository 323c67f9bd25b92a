// cim_mbiw.cu - the CIM-MBIW input-serial int8 matmul with the fused
// DSCI-ADC + ABN epilogue, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/cim_mbiw/kernel.py:_cim_mbiw_kernel
// (entry cim_mbiw_matmul_planes).  It computes
//
//   dp[m, n]   = sum_p 2^(plane_shift*p) * sum_k x[m, p*K + k] * w[k, n]
//   code[m, n] = clip(floor((mid + f32(f32(gamma[n]*g0) * f32(dp))) + beta),
//                     0, 2^r_out - 1)
//
// over P plane-major int8 input planes, with beta per column (1, N) or per
// GEMM row (M, N), or returns the raw int32 dp when fuse_adc == 0.
//
// Design.  Each block owns one BM x BN output tile.  The loop over K
// blocks x planes runs inside the block with the int32 accumulator in
// registers; it replaces the TPU grid's sequential "arbitrary" K axis and
// its VMEM scratch.  A K block of the weights is staged in shared memory
// once and reused by every input plane.  Operands are packed four int8
// values to a 32-bit word along K, and each thread forms a TM x TN patch
// of products with __dp4a (int8 x int8 -> int32; inputs are < 128 and
// weights |w| <= 15, so the signed byte product is exact).  The block
// masks the ragged M/N/K edges itself (zero fill), so no caller pads.
//
// The epilogue rounds every step explicitly (__fmul_rn, __fadd_rn) in the
// contract's order.  A fused multiply-add of gain*dp into mid+beta rounds
// once where the contract rounds twice and flips codes at floor
// boundaries; the _rn intrinsics are never contracted, and the file is
// built without --use_fast_math.
//
// Bound on an H100 SXM: the int8 work is 2*M*N*K*P operations against
// 1979 TOP/s of int8 tensor-core rate, and the bytes are M*P*K + K*N
// in, 4*M*N out (+ 4*M*N for a per-row beta) against 3.35 TB/s.  At
// LeNet's shapes (K <= 1152, N <= 128) the bytes bound it.  This simple
// design leaves most of the card unused: dp4a runs on the CUDA cores at a
// small fraction of the tensor-core rate, operands are loaded byte by byte
// without cp.async/TMA double buffering, a K block of 32 wastes most of
// its work when K is 9 (conv1), and a 64-wide tile wastes 3/4 of a block
// when N is 16.  wgmma with TMA-fed shared-memory stages, and tiles
// shaped to the layer, are the later step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // output rows per block
constexpr int BN = 64;          // output columns per block
constexpr int BK = 32;          // K elements per shared-memory stage
constexpr int BK4 = BK / 4;     // packed 32-bit words per stage row
constexpr int TY = 16;          // thread rows
constexpr int TX = 16;          // thread columns
constexpr int TM = BM / TY;     // outputs per thread along M
constexpr int TN = BN / TX;     // outputs per thread along N
constexpr int THREADS = TY * TX;

__device__ __forceinline__ int32_t pack4(int8_t a, int8_t b, int8_t c,
                                         int8_t d) {
  return (int32_t)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
                   ((uint32_t)(uint8_t)c << 16) |
                   ((uint32_t)(uint8_t)d << 24));
}

__global__ void __launch_bounds__(THREADS)
cim_mbiw_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, int32_t* __restrict__ out,
                int M, int N, int K, int P, int plane_shift, float g0,
                int r_out, int fuse_adc, int beta_rows) {
  // operands packed along K: word [k4][i] holds k = 4*k4 .. 4*k4+3.
  // Threads read row/column i = t + 16*j, so neighbouring threads hit
  // neighbouring banks.
  __shared__ int32_t sx[BK4][BM];
  __shared__ int32_t sw[BK4][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const size_t ldx = (size_t)P * K;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous stage's weights are no longer read
    // weights: BK x BN bytes -> BK4 x BN words, consecutive threads on
    // consecutive columns of one weight row
    for (int idx = tid; idx < BK4 * BN; idx += THREADS) {
      const int n = idx % BN, k4 = idx / BN;
      const int gn = n0 + n;
      int8_t b[4] = {0, 0, 0, 0};
      if (gn < N) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gk = k0 + 4 * k4 + e;
          if (gk < K) b[e] = w[(size_t)gk * N + gn];
        }
      }
      sw[k4][n] = pack4(b[0], b[1], b[2], b[3]);
    }
    for (int p = 0; p < P; ++p) {
      __syncthreads();  // the previous plane's inputs are no longer read
      // inputs of plane p: BM x BK bytes -> BK4 x BM words
      for (int idx = tid; idx < BM * BK4; idx += THREADS) {
        const int k4 = idx % BK4, m = idx / BK4;
        const int gm = m0 + m;
        int8_t b[4] = {0, 0, 0, 0};
        if (gm < M) {
          const int8_t* row = x + (size_t)gm * ldx + (size_t)p * K;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int gk = k0 + 4 * k4 + e;
            if (gk < K) b[e] = row[gk];
          }
        }
        sx[k4][m] = pack4(b[0], b[1], b[2], b[3]);
      }
      __syncthreads();
      int32_t part[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = 0;
#pragma unroll
      for (int k4 = 0; k4 < BK4; ++k4) {
        int32_t a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = sx[k4][ty + TY * i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = sw[k4][tx + TX * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            part[i][j] = __dp4a(a[i], b[j], part[i][j]);
      }
      // the plane's partial dp enters the accumulator at 2^(shift*p);
      // unsigned arithmetic wraps exactly like the TPU's int32 adds
      const uint32_t scale = 1u << (plane_shift * p);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += (uint32_t)part[i][j] * scale;
    }
  }

  const float mid = (float)(1 << (r_out - 1));
  const float top = (float)((1 << r_out) - 1);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + TY * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx + TX * j;
      if (gn >= N) continue;
      const int32_t dp = (int32_t)acc[i][j];
      const size_t o = (size_t)gm * N + gn;
      if (!fuse_adc) {
        out[o] = dp;
        continue;
      }
      const float gain = __fmul_rn(gamma[gn], g0);
      const float t = __fmul_rn(gain, __int2float_rn(dp));
      const float b = beta_rows ? beta[o] : beta[gn];
      float code = floorf(__fadd_rn(__fadd_rn(mid, t), b));
      code = fminf(fmaxf(code, 0.0f), top);
      out[o] = (int32_t)code;
    }
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError(): non-zero when the launch was refused.
extern "C" int cim_mbiw_launch(const void* x, const void* w,
                               const void* gamma, const void* beta,
                               void* out, int M, int N, int K, int P,
                               int plane_shift, float g0, int r_out,
                               int fuse_adc, int beta_rows, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  cim_mbiw_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)gamma,
      (const float*)beta, (int32_t*)out, M, N, K, P, plane_shift, g0, r_out,
      fuse_adc, beta_rows);
  return (int)cudaGetLastError();
}

extern "C" const char* cim_mbiw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

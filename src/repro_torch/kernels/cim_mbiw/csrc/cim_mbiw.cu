// cim_mbiw.cu - the CIM-MBIW input-serial int8 matmul with the fused
// DSCI-ADC + ABN epilogue on the CUDA cores, for NVIDIA Hopper (sm_90a):
// route C of kernels/cim_mbiw/kernel.py, the route for K < 32 (LeNet's
// conv1, K 9), for M >= 64 with K not a multiple of 16 (no TMA there),
// and for more than two input planes.
//
// Replaces the TPU kernel repro/kernels/cim_mbiw/kernel.py:_cim_mbiw_kernel
// (entry cim_mbiw_matmul_planes) on those shapes; cim_mbiw_tc.cu (tensor
// cores) and cim_mbiw_splitk.cu (split-K) take the rest.  It computes
//
//   dp[m, n]   = sum_p 2^(plane_shift*p) * sum_k x[m, p*K + k] * w[k, n]
//   code[m, n] = clip(floor((mid + f32(f32(gamma[n]*g0) * f32(dp))) + beta),
//                     0, 2^r_out - 1)
//
// over P plane-major int8 input planes, with beta per column (1, N) or per
// GEMM row (M, N), or returns the raw int32 dp when fuse_adc == 0.
//
// Design (the first port's, with the tile width fitted to N).  Each block
// of 256 threads owns one BM x BN output tile, BN 16, 32 or 64 (a template
// parameter chosen from N) and BM = 4 * 256 / (BN / 4) rows, so conv1's
// N 16 fills whole blocks.  The loop over K blocks x planes runs inside the
// block with the int32 accumulator in registers; a K block of the weights
// is staged in shared memory once and reused by every input plane.
// Operands are packed four int8 values to a 32-bit word along K, and each
// thread forms a 4 x 4 patch of products with __dp4a (int8 x int8 ->
// int32), skipping the words of a stage past K (conv1 uses 3 of 8).  A
// thread owns four consecutive columns and stores them as one 16-byte
// store where N allows, so a warp writes whole rows of conv1's output.
// The block masks the ragged M/N/K edges itself (zero fill).
//
// Bound on an H100 SXM: conv1 (M 200704, K 9, N 16) is bound by its
// 12.8 MB int32 output (bytes); dp4a on the CUDA cores is far below the
// int8 tensor-core rate, which is why the larger-K shapes go elsewhere.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cim_epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BK = 32;          // K elements per shared-memory stage
constexpr int BK4 = BK / 4;     // packed 32-bit words per stage row
constexpr int TM = 4;           // outputs per thread along M
constexpr int TN = 4;           // consecutive outputs per thread along N

__device__ __forceinline__ int32_t pack4(int8_t a, int8_t b, int8_t c,
                                         int8_t d) {
  return (int32_t)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
                   ((uint32_t)(uint8_t)c << 16) |
                   ((uint32_t)(uint8_t)d << 24));
}

template <int BN>
__global__ void __launch_bounds__(THREADS)
cim_mbiw_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ gamma,
                const float* __restrict__ beta, int32_t* __restrict__ out,
                int M, int N, int K, int P, int plane_shift, cim::Adc adc,
                int beta_rows) {
  constexpr int TX = BN / TN;           // thread columns
  constexpr int TY = THREADS / TX;      // thread rows
  constexpr int BM = TY * TM;           // output rows per block
  // operands packed along K: word [k4][i] holds k = 4*k4 .. 4*k4+3
  __shared__ int32_t sx[BK4][BM];
  __shared__ __align__(16) int32_t sw[BK4][BN];

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
    // words of this stage that hold any k < K
    const int k4n = min(BK4, (K - k0 + 3) / 4);
    __syncthreads();  // the previous stage's weights are no longer read
    // weights: BK x BN bytes -> BK4 x BN words, consecutive threads on
    // consecutive columns of one weight row
    for (int idx = tid; idx < BK4 * BN; idx += THREADS) {
      const int n = idx % BN, k4 = idx / BN;
      if (k4 >= k4n) break;
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
        if (k4 >= k4n) continue;
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
        if (k4 < k4n) {
          int32_t a[TM];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = sx[k4][ty + TY * i];
          const int4 b = *reinterpret_cast<const int4*>(&sw[k4][TN * tx]);
          const int32_t bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              part[i][j] = __dp4a(a[i], bv[j], part[i][j]);
        }
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

  const int gn0 = n0 + TN * tx;
  if (gn0 >= N) return;
  float g[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) g[j] = gn0 + j < N ? gamma[gn0 + j] : 0.0f;
  const bool vec = (N % 4 == 0) && gn0 + TN <= N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty + TY * i;
    if (gm >= M) continue;
    int32_t c[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = gn0 + j;
      c[j] = gn < N ? cim::adc_code(adc, (int32_t)acc[i][j], g[j],
                                    cim::beta_at(beta, beta_rows, gm, gn, N))
                    : 0;
    }
    int32_t* o = out + (size_t)gm * N + gn0;
    if (vec) {
      *reinterpret_cast<int4*>(o) = make_int4(c[0], c[1], c[2], c[3]);
    } else {
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (gn0 + j < N) o[j] = c[j];
    }
  }
}

template <int BN>
int launch(const void* x, const void* w, const void* gamma,
           const void* beta, void* out, int M, int N, int K, int P,
           int plane_shift, cim::Adc adc, int beta_rows,
           cudaStream_t stream) {
  constexpr int BM = THREADS / (BN / TN) * TM;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  cim_mbiw_kernel<BN><<<grid, THREADS, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)gamma,
      (const float*)beta, (int32_t*)out, M, N, K, P, plane_shift, adc,
      beta_rows);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): x (M, P*K) and w (K, N) int8,
// gamma (1, N) and beta (1, N) or (M, N) float32, out (M, N) int32, all
// contiguous; bn the tile width, 16, 32 or 64.  Launches on `stream` and
// returns cudaGetLastError(): non-zero when the launch was refused.
extern "C" int cim_mbiw_launch(const void* x, const void* w,
                               const void* gamma, const void* beta,
                               void* out, int M, int N, int K, int P,
                               int plane_shift, float g0, int r_out,
                               int fuse_adc, int beta_rows, int bn,
                               void* stream) {
  const cim::Adc adc = cim::make_adc(g0, r_out, fuse_adc);
  auto s = (cudaStream_t)stream;
  switch (bn) {
    case 16: return launch<16>(x, w, gamma, beta, out, M, N, K, P,
                               plane_shift, adc, beta_rows, s);
    case 32: return launch<32>(x, w, gamma, beta, out, M, N, K, P,
                               plane_shift, adc, beta_rows, s);
    case 64: return launch<64>(x, w, gamma, beta, out, M, N, K, P,
                               plane_shift, adc, beta_rows, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cim_mbiw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

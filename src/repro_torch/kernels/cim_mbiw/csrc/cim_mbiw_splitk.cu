// cim_mbiw_splitk.cu - the CIM-MBIW input-serial int8 matmul with the
// fused DSCI-ADC + ABN epilogue for few rows (M < 64, K >= 32), split
// over K, for NVIDIA Hopper (sm_90a): route B of
// kernels/cim_mbiw/kernel.py.  It serves every decode tile (M 1-4, K 1024,
// N 64/128) and LeNet's fc layers at small batches.
//
// Replaces the TPU kernel repro/kernels/cim_mbiw/kernel.py:_cim_mbiw_kernel
// (entry cim_mbiw_matmul_planes) on those shapes, with its function:
//
//   dp[m, n]   = sum_p 2^(plane_shift*p) * sum_k x[m, p*K + k] * w[k, n]
//   code[m, n] = clip(floor((mid + f32(f32(gamma[n]*g0) * f32(dp))) + beta),
//                     0, 2^r_out - 1)
//
// with beta per column (1, N) or per GEMM row (M, N), or the raw int32 dp
// when fuse_adc == 0.
//
// Bound on an H100 SXM: the weight bytes.  A decode tile reads 64-128 KB
// of weights for a few thousand output values; its bound is 0.02-0.04 us
// of memory time, and what a call really costs is latency: the launch, one
// round trip to memory and the combination of the partial sums.
//
// Design.  The grid is (N tiles of 64 columns) x (K chunks of KC rows),
// about one block per SM, so a decode tile's weights stream through the
// whole card at once instead of through 2 SMs.  A block loads its x chunk
// with the planes combined, xc[m][k] = sum_p x_p[m][k] << (shift * p)
// (exact mod 2^32, like the kernel's int32 accumulator), and its KC x 64
// weight chunk with 16-byte coalesced loads where N allows (byte loads
// otherwise); every thread then owns one column and rows m = j, j + 4, ..
// and sums its chunk's products in uint32.  The partial sums combine by
// atomicAdd into an int32 workspace (M x N); integer addition is
// associative, so the order in which chunks arrive changes nothing, bit
// for bit.  The last block of each N tile (a ticket counter per tile)
// takes every sum back with atomicExch(.., 0), applies the epilogue and
// resets its counter, so the workspace is zero again when the call ends
// and needs no memset.  The wrapper allocates the workspace once per
// device (zeros) and grows it when a call needs more; one stream at a time
// may use it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cim_epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BN = 64;                  // columns a block
constexpr int ROW_GROUPS = THREADS / BN;

__global__ void __launch_bounds__(THREADS)
cim_mbiw_splitk_kernel(const int8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       int32_t* __restrict__ out, int32_t* __restrict__ ws,
                       unsigned int* __restrict__ tickets, int M, int N,
                       int K, int P, int plane_shift, int KC, cim::Adc adc,
                       int beta_rows, int wvec) {
  // the weight chunk (KC x BN int8, row-major) first, 16-byte aligned;
  // then the combined x chunk (M x KC uint32)
  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* sw = reinterpret_cast<int8_t*>(smem);
  uint32_t* sx = reinterpret_cast<uint32_t*>(smem + KC * BN);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * KC;
  const int kc = min(KC, K - k0);
  const size_t ldx = (size_t)P * K;

  for (int idx = tid; idx < M * kc; idx += THREADS) {
    const int m = idx / kc, k = idx % kc;
    const int8_t* row = x + (size_t)m * ldx + k0 + k;
    uint32_t v = 0u;
    for (int p = 0; p < P; ++p)
      v += (uint32_t)(int32_t)row[(size_t)p * K] << (plane_shift * p);
    sx[m * KC + k] = v;
  }
  if (wvec) {
    // N % 16 == 0 and w 16-byte aligned: a 16-column piece of a weight
    // row is all in N or all past it
    for (int idx = tid; idx < kc * (BN / 16); idx += THREADS) {
      const int r = idx / (BN / 16), c = 16 * (idx % (BN / 16));
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + c < N)
        v = __ldg(reinterpret_cast<const uint4*>(
            w + (size_t)(k0 + r) * N + n0 + c));
      *reinterpret_cast<uint4*>(sw + r * BN + c) = v;
    }
  } else {
    for (int idx = tid; idx < kc * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      sw[r * BN + c] = n0 + c < N ? w[(size_t)(k0 + r) * N + n0 + c] : 0;
    }
  }
  __syncthreads();

  const int n = tid % BN;
  const int gn = n0 + n;
  for (int m = tid / BN; m < M; m += ROW_GROUPS) {
    const uint32_t* xr = sx + m * KC;
    uint32_t acc = 0u;
    for (int k = 0; k < kc; ++k)
      acc += xr[k] * (uint32_t)(int32_t)sw[k * BN + n];
    if (gn < N) atomicAdd(&ws[(size_t)m * N + gn], (int32_t)acc);
  }

  // the last block of this N tile to finish applies the epilogue
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int idx = tid; idx < M * BN; idx += THREADS) {
    const int m = idx / BN, c = n0 + idx % BN;
    if (c >= N) continue;
    const int32_t dp = atomicExch(&ws[(size_t)m * N + c], 0);
    out[(size_t)m * N + c] = cim::adc_code(
        adc, dp, gamma[c], cim::beta_at(beta, beta_rows, m, c, N));
  }
  if (tid == 0) atomicExch(&tickets[blockIdx.x], 0u);
}

}  // namespace

// Plain C entry point (loaded with ctypes): x (M, P*K) and w (K, N) int8,
// gamma (1, N) and beta (1, N) or (M, N) float32, out (M, N) int32, all
// contiguous; ws at least M * N int32 and tickets ceil(N / 64) uint32,
// both zero (they are zero again when the kernel ends); kc the K rows a
// chunk (1..128), M at most 63; wvec 1 when N % 16 == 0 and w is 16-byte
// aligned.  Launches on `stream` and returns cudaGetLastError().
extern "C" int cim_mbiw_splitk_launch(const void* x, const void* w,
                                      const void* gamma, const void* beta,
                                      void* out, void* ws, void* tickets,
                                      int M, int N, int K, int P,
                                      int plane_shift, float g0, int r_out,
                                      int fuse_adc, int beta_rows, int kc,
                                      int wvec, void* stream) {
  if (M < 1 || M > 63 || kc < 1 || kc > 128)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (K + kc - 1) / kc);
  const size_t smem = (size_t)kc * BN + (size_t)M * kc * 4;
  cim_mbiw_splitk_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, (const float*)gamma,
      (const float*)beta, (int32_t*)out, (int32_t*)ws,
      (unsigned int*)tickets, M, N, K, P, plane_shift, kc,
      cim::make_adc(g0, r_out, fuse_adc), beta_rows, wvec);
  return (int)cudaGetLastError();
}

extern "C" const char* cim_mbiw_splitk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

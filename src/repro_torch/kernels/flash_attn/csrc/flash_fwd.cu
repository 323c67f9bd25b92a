// flash_fwd.cu - flash attention forward for NVIDIA Hopper (sm_90a), on
// the CUDA cores: the kernel for float32 inputs, and for bfloat16 inputs
// at head dimensions other than 64 and 128.  bfloat16 at D 64 or 128 (the
// train path) runs on the tensor cores in flash_fwd_tc.cu.
//
// Replaces the TPU kernel repro/kernels/flash_attn/kernel.py:_flash_kernel
// (entry flash_attention_bhsd).  For batch b, query head h and its kv head
// g = h / rep it computes, in float32 from float32 or bfloat16 inputs,
//
//   s[i, j] = (q[i] * scale) . k[j]          (scale = 1 / sqrt(D), q first)
//   s[i, j] = -1e30 where the mask drops (i, j)
//   O[i]    = sum_j exp(s[i, j] - m_i) v[j] / max(l_i, 1e-30)
//   lse[i]  = m_i + log(max(l_i, 1e-30))
//
// by the online softmax (running max m, running sum l, a correction
// exp(m_old - m_new) per key tile), as the TPU kernel does.  The mask keeps
// (i, j) when j <= q_off + i (causal) and q_off + i - j < window (window >
// 0); q_off, the global position of query row 0, is a device int32.  O is
// written in q's dtype, lse in float32.
//
// Design.  One block of 256 threads per (64-row query tile, head, batch);
// it walks the key tiles of 64 rows through shared memory (q, k, v tiles
// of 64 x (D+1) floats and a 64 x 65 probability tile: 113 KB at D = 128,
// 209 KB at D = 256, above the 48 KB default, so the launch opts in).  The
// kernel is compiled for two head-dimension bounds (flash_common.cuh): D
// <= 128 and D <= 256; the second holds 16 output values a thread per row
// and fits one block on an SM.  The ragged edges are
// masked, never padded: rows past Sq are computed and not stored, keys
// past Sk get probability exactly 0.  Key tiles that the mask drops for
// every row of the query tile are skipped; that is exact (an early tile's
// contribution is wiped by a later correction exp(-1e30 - m) = 0, a late
// one adds exp(-1e30 - m) = 0), except for a row that keeps no key at all,
// whose softmax is uniform over the Sk keys.  When the tile has such a row
// nothing is skipped, so that row matches the plain version.
//
// Bound on an H100 SXM: operations.  At B 2, H 16, S 4096, D 128, causal,
// the two products are 2*B*H*S*S*D = 137 GFLOP, 0.14 ms at the bf16
// tensor-core rate, against 67 MB of q/k/v/O (0.02 ms).  This kernel runs
// the products as float32 FMAs on the CUDA cores (no mma/wgmma, no TMA or
// cp.async pipeline), so it is far from that bound; it keeps float32
// inputs to their float32 limits, which one bf16 tensor-core pass over
// float32 operands could not.

#include "flash_common.cuh"

namespace flash {
namespace {

template <typename T, int MAXD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ q_off_p,
                 T* __restrict__ o, float* __restrict__ lse, Strides sq,
                 Strides sk, Strides sv, Strides so, int rep, int Sq, int Sk,
                 int D, int causal, int window, float scale) {
  constexpr int DJ = MAXD / 16;
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* Qs = smem;
  float* Ks = Qs + BQ * ld;
  float* Vs = Ks + BK * ld;
  float* Ps = Vs + BK * ld;  // BQ x (BK + 1)
  const int pld = BK + 1;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, g = h / rep;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q_off = *q_off_p;

  load_tile(Qs, q, sq, b, h, q0, BQ, Sq, D, scale);

  // key tiles to visit: skip those the mask drops for every row, unless a
  // row of this tile keeps no key at all
  const int n_kt = (Sk + BK - 1) / BK;
  const int last_row = min(q0 + BQ, Sq) - 1;
  bool every_row_keeps = true;
  for (int r = q0; r <= last_row; ++r) {
    const int qp = q_off + r;
    const int lo = window > 0 ? max(0, qp - window + 1) : 0;
    const int hi = causal ? min(Sk - 1, qp) : Sk - 1;
    every_row_keeps = every_row_keeps && lo <= hi;
  }
  int kt0 = 0, kt1 = n_kt;
  if (every_row_keeps) {
    if (window > 0) kt0 = max(0, q_off + q0 - window + 1) / BK;
    if (causal) kt1 = min(n_kt, (q_off + last_row) / BK + 1);
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile(Ks, k, sk, b, g, k0, BK, Sk, D, 1.0f);
    load_tile(Vs, v, sv, b, g, k0, BK, Sk, D, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q_off + q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        if (kp >= Sk)
          s[i][j] = -INFINITY;  // no key: probability exactly 0
        else if (!keep(qp, kp, causal, window))
          s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * pld + tx + 16 * j] = p;
        sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * pld + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float vv = Vs[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += pv[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + b * so.b + (long long)r * so.s + h * so.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(orow + d, acc[i][j] / l_safe);
    }
    if (tx == 0)
      lse[((long long)b * gridDim.y + h) * Sq + r] = m[i] + logf(l_safe);
  }
}

template <typename T, int MAXD>
int launch(const void* q, const void* k, const void* v, const void* q_off,
           void* o, void* lse, const long long* st, int B, int H, int rep,
           int Sq, int Sk, int D, int causal, int window, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)((BQ + 2 * BK) * (D + 1)
                                               + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, MAXD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, MAXD><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)q_off, (T*)o,
      (float*)lse, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, rep, Sq,
      Sk, D, causal, window, scale);
  return (int)cudaGetLastError();
}

// the instantiation for D's bound
template <typename T>
int launch_d(const void* q, const void* k, const void* v, const void* q_off,
             void* o, void* lse, const long long* st, int B, int H, int rep,
             int Sq, int Sk, int D, int causal, int window, float scale,
             cudaStream_t stream) {
  if (D <= MAX_D_SMALL)
    return launch<T, MAX_D_SMALL>(q, k, v, q_off, o, lse, st, B, H, rep, Sq,
                                  Sk, D, causal, window, scale, stream);
  return launch<T, MAX_D>(q, k, v, q_off, o, lse, st, B, H, rep, Sq, Sk, D,
                          causal, window, scale, stream);
}

}  // namespace
}  // namespace flash

// Plain C entry point (loaded with ctypes).  q (B, H, Sq, D) and k/v
// (B, H / rep, Sk, D) of `dtype` (0 float32, 1 bfloat16), read through
// the strides st = [q b, s, h, k b, s, h, v b, s, h, o b, s, h] (elements,
// head dimension contiguous); q_off one device int32; o (B, H, Sq, D) of
// `dtype` through its strides, lse (B, H, Sq) float32 contiguous.  Launches
// on `stream` and returns the CUDA error code (0 when the launch was
// accepted; cudaErrorInvalidValue for D outside 1..256).
extern "C" int flash_fwd_launch(int dtype, const void* q, const void* k,
                                const void* v, const void* q_off, void* o,
                                void* lse, const long long* strides, int B,
                                int H, int rep, int Sq, int Sk, int D,
                                int causal, int window, float scale,
                                void* stream) {
  if (D < 1 || D > flash::MAX_D) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  if (dtype == flash::F32)
    return flash::launch_d<float>(q, k, v, q_off, o, lse, strides, B, H,
                                  rep, Sq, Sk, D, causal, window, scale, s);
  if (dtype == flash::BF16)
    return flash::launch_d<__nv_bfloat16>(q, k, v, q_off, o, lse, strides,
                                          B, H, rep, Sq, Sk, D, causal,
                                          window, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// flash_bwd.cu - flash attention backward for NVIDIA Hopper (sm_90a), on
// the CUDA cores: dq and dk/dv for float32 inputs and for bfloat16 inputs
// at head dimensions other than 64 and 128.  bfloat16 at D 64 or 128 (the
// train path) runs on the tensor cores, in flash_bwd_dq_tc.cu and
// flash_bwd_dkv_tc.cu.
//
// Replaces the two TPU kernels of repro/kernels/flash_attn/kernel.py
// (entry flash_attention_bwd_bhsd):
//
//   _flash_bwd_dq_kernel   dq[i]  = sum_j ds[i, j] k[j]
//   _flash_bwd_dkv_kernel  dk[j]  = sum_i ds[i, j] q[i],
//                          dv[j]  = sum_i p[i, j] dO[i]   (per query head)
//
// with the probabilities recomputed from the forward's row logsumexp, in
// the JAX kernels' order (the dot first, then the scale):
//
//   s[i, j]  = scale * (q[i] . k[j])
//   p[i, j]  = exp(s[i, j] - lse[i])  where the mask keeps (i, j), else 0
//   ds[i, j] = p[i, j] * (dO[i] . v[j] - delta[i]) * scale
//
// delta[i] = dO[i] . O[i] comes from the caller.  Inputs are float32 or
// bfloat16 (q, k, v, dO) and float32 (lse, delta), read through strides
// with the head dimension contiguous; dq, dk, dv are float32.  dk and dv
// are per query head: the caller sums each kv group's rep heads.
//
// Design.  dq: one block of 256 threads per (64-row query tile, head,
// batch), walking the key tiles.  dk/dv: one block per (64-row key tile,
// head, batch), walking the query tiles; a thread owns key rows, so the two
// sums stay in its registers.  Tiles are 64 x (D+1) floats in shared
// memory (dq: q, dO, k, v and a ds tile, 145 KB at D = 128; dk/dv: k, v,
// q, dO, p and ds tiles, 162 KB), above the 48 KB default, so the launches
// opt in.  At 128 < D <= 256 (the second head-dimension bound of
// flash_common.cuh) dq walks 32-row key tiles and dk/dv 32-row query
// tiles: 201 KB and 209 KB of float32 tiles, one block an SM.  Tiles the
// mask drops entirely are skipped (their p is 0).  Every sum runs in a
// fixed order and nothing is added atomically, so a call repeats bit for
// bit.  Ragged edges are masked, never padded.
//
// Bound on an H100 SXM: operations.  At B 2, H 16, S 4096, D 128, causal,
// dq does three products (3*B*H*S*S*D = 206 GFLOP, 0.21 ms at the bf16
// tensor-core rate) and dk/dv four (275 GFLOP, 0.28 ms); the bytes are
// under 0.06 ms.  Like flash_fwd.cu, these kernels run the products as
// float32 FMAs on the CUDA cores, far from that bound.

#include "flash_common.cuh"

namespace flash {
namespace {

struct BwdArgs {
  Strides q, k, v, dout, dq, dk, dv;
  int rep, Sq, Sk, D, causal, window;
  float scale;
};

template <typename T, int MAXD, int BKT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ q_off_p, float* __restrict__ dq,
                    BwdArgs a) {
  constexpr int DJ = MAXD / 16, NJ = BKT / 16;
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1, pld = BKT + 1;
  float* Qs = smem;
  float* dOs = Qs + BQ * ld;
  float* Ks = dOs + BQ * ld;
  float* Vs = Ks + BKT * ld;
  float* dSs = Vs + BKT * ld;  // BQ x (BKT + 1)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, g = h / a.rep;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q_off = *q_off_p;
  const long long stat0 = ((long long)b * gridDim.y + h) * a.Sq;

  load_tile(Qs, q, a.q, b, h, q0, BQ, a.Sq, D, 1.0f);
  load_tile(dOs, dout, a.dout, b, h, q0, BQ, a.Sq, D, 1.0f);
  float lse_i[4], delta_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_i[i] = r < a.Sq ? lse[stat0 + r] : 0.0f;
    delta_i[i] = r < a.Sq ? delta[stat0 + r] : 0.0f;
  }

  const int n_kt = (a.Sk + BKT - 1) / BKT;
  const int last_row = min(q0 + BQ, a.Sq) - 1;
  int kt0 = 0, kt1 = n_kt;
  if (a.window > 0) kt0 = max(0, q_off + q0 - a.window + 1) / BKT;
  if (a.causal) kt1 = max(0, min(n_kt, floor_div(q_off + last_row, BKT) + 1));

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * BKT;
    __syncthreads();
    load_tile(Ks, k, a.k, b, g, k0, BKT, a.Sk, D, 1.0f);
    load_tile(Vs, v, a.v, b, g, k0, BKT, a.Sk, D, 1.0f);
    __syncthreads();

    float s[4][NJ], dp[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float qv[4], ov[4], kv[NJ], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * ld + d];
        ov[i] = dOs[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        kv[j] = Ks[(tx + 16 * j) * ld + d];
        vv[j] = Vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += ov[i] * vv[j];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int kp = k0 + tx + 16 * j;
        float p = 0.0f;
        if (r < a.Sq && kp < a.Sk && keep(q_off + r, kp, a.causal, a.window))
          p = expf(__fmul_rn(a.scale, s[i][j]) - lse_i[i]);
        dSs[(ty + 16 * i) * pld + tx + 16 * j] =
            p * (dp[i][j] - delta_i[i]) * a.scale;
      }
    }
    __syncthreads();

    for (int c = 0; c < BKT; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty + 16 * i) * pld + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float kv = Ks[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += dsv[i] * kv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.Sq) continue;
    float* row = dq + b * a.dq.b + (long long)r * a.dq.s + h * a.dq.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = acc[i][j];
    }
  }
}

template <typename T, int MAXD, int BQT>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const int* __restrict__ q_off_p,
                     float* __restrict__ dk, float* __restrict__ dv,
                     BwdArgs a) {
  constexpr int DJ = MAXD / 16, NJ = BQT / 16;
  extern __shared__ float smem[];
  const int D = a.D, ld = D + 1, pld = BQT + 1;
  float* Ks = smem;
  float* Vs = Ks + BK * ld;
  float* Qs = Vs + BK * ld;
  float* dOs = Qs + BQT * ld;
  float* Pt = dOs + BQT * ld;  // BK x (BQT + 1): p, keys as rows
  float* dSt = Pt + BK * pld;  // BK x (BQT + 1): ds, keys as rows
  float* lse_s = dSt + BK * pld;
  float* delta_s = lse_s + BQT;

  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z, g = h / a.rep;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int q_off = *q_off_p;
  const long long stat0 = ((long long)b * gridDim.y + h) * a.Sq;

  load_tile(Ks, k, a.k, b, g, k0, BK, a.Sk, D, 1.0f);
  load_tile(Vs, v, a.v, b, g, k0, BK, a.Sk, D, 1.0f);

  // query tiles to visit: causal needs q_off + i >= j, a window needs
  // q_off + i - j < window
  const int n_qt = (a.Sq + BQT - 1) / BQT;
  const int last_key = min(k0 + BK, a.Sk) - 1;
  int qt0 = 0, qt1 = n_qt;
  if (a.causal) qt0 = min(n_qt, max(0, k0 - q_off) / BQT);
  if (a.window > 0)
    qt1 = max(0, min(n_qt, floor_div(last_key + a.window - 1 - q_off, BQT)
                                + 1));

  float acc_k[4][DJ], acc_v[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * BQT;
    __syncthreads();
    load_tile(Qs, q, a.q, b, h, q0, BQT, a.Sq, D, 1.0f);
    load_tile(dOs, dout, a.dout, b, h, q0, BQT, a.Sq, D, 1.0f);
    for (int r = threadIdx.x; r < BQT; r += THREADS) {
      lse_s[r] = q0 + r < a.Sq ? lse[stat0 + q0 + r] : 0.0f;
      delta_s[r] = q0 + r < a.Sq ? delta[stat0 + q0 + r] : 0.0f;
    }
    __syncthreads();

    // rows: keys ty + 16 i; columns: queries tx + 16 j
    float s[4][NJ], dp[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) s[i][j] = dp[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float kv[4], vv[4], qv[NJ], ov[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kv[i] = Ks[(ty + 16 * i) * ld + d];
        vv[i] = Vs[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        qv[j] = Qs[(tx + 16 * j) * ld + d];
        ov[j] = dOs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          s[i][j] += qv[j] * kv[i];
          dp[i][j] += ov[j] * vv[i];
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kp = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int r = q0 + tx + 16 * j;
        float p = 0.0f;
        if (r < a.Sq && kp < a.Sk && keep(q_off + r, kp, a.causal, a.window))
          p = expf(__fmul_rn(a.scale, s[i][j]) - lse_s[tx + 16 * j]);
        Pt[(ty + 16 * i) * pld + tx + 16 * j] = p;
        dSt[(ty + 16 * i) * pld + tx + 16 * j] =
            p * (dp[i][j] - delta_s[tx + 16 * j]) * a.scale;
      }
    }
    __syncthreads();

    for (int c = 0; c < BQT; ++c) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Pt[(ty + 16 * i) * pld + c];
        dsv[i] = dSt[(ty + 16 * i) * pld + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        if (d < D) {
          const float ov = dOs[c * ld + d];
          const float qv = Qs[c * ld + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][j] += pv[i] * ov;
            acc_k[i][j] += dsv[i] * qv;
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= a.Sk) continue;
    float* krow = dk + b * a.dk.b + (long long)kp * a.dk.s + h * a.dk.h;
    float* vrow = dv + b * a.dv.b + (long long)kp * a.dv.s + h * a.dv.h;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) {
        krow[d] = acc_k[i][j];
        vrow[d] = acc_v[i][j];
      }
    }
  }
}

BwdArgs make_args(const long long* st, int rep, int Sq, int Sk, int D,
                  int causal, int window, float scale) {
  BwdArgs a;
  Strides* all[7] = {&a.q, &a.k, &a.v, &a.dout, &a.dq, &a.dk, &a.dv};
  for (int i = 0; i < 7; ++i)
    *all[i] = Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
  a.rep = rep;
  a.Sq = Sq;
  a.Sk = Sk;
  a.D = D;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  return a;
}

template <typename T, int MAXD, int BKT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* q_off,
              void* dq, int B, int H, const BwdArgs& a,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * (BQ + BKT) * (a.D + 1)
                                               + BQ * (BKT + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, MAXD, BKT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, H, B);
  flash_bwd_dq_kernel<T, MAXD, BKT><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const int*)q_off, (float*)dq,
      a);
  return (int)cudaGetLastError();
}

template <typename T, int MAXD, int BQT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, const void* q_off,
               void* dk, void* dv, int B, int H, const BwdArgs& a,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * (BQT + BK) * (a.D + 1)
                                               + 2 * BK * (BQT + 1)
                                               + 2 * BQT);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, MAXD, BQT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sk + BK - 1) / BK, H, B);
  flash_bwd_dkv_kernel<T, MAXD, BQT><<<grid, THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
      (const float*)lse, (const float*)delta, (const int*)q_off, (float*)dk,
      (float*)dv, a);
  return (int)cudaGetLastError();
}

// the instantiations for D's bound: 64-row tiles at D <= 128; at D <= 256
// 32-row key tiles (dq) and query tiles (dk/dv), whose float32 tiles then
// fit in the shared memory a block can opt in to (201 KB and 209 KB)
template <typename T>
int launch_dq_d(const void* q, const void* k, const void* v,
                const void* dout, const void* lse, const void* delta,
                const void* q_off, void* dq, int B, int H, const BwdArgs& a,
                cudaStream_t stream) {
  if (a.D <= MAX_D_SMALL)
    return launch_dq<T, MAX_D_SMALL, BK>(q, k, v, dout, lse, delta, q_off,
                                         dq, B, H, a, stream);
  return launch_dq<T, MAX_D, BK / 2>(q, k, v, dout, lse, delta, q_off, dq, B,
                                     H, a, stream);
}

template <typename T>
int launch_dkv_d(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 const void* q_off, void* dk, void* dv, int B, int H,
                 const BwdArgs& a, cudaStream_t stream) {
  if (a.D <= MAX_D_SMALL)
    return launch_dkv<T, MAX_D_SMALL, BQ>(q, k, v, dout, lse, delta, q_off,
                                          dk, dv, B, H, a, stream);
  return launch_dkv<T, MAX_D, BQ / 2>(q, k, v, dout, lse, delta, q_off, dk,
                                      dv, B, H, a, stream);
}

}  // namespace
}  // namespace flash

// Plain C entry points (loaded with ctypes).  q, dO (B, H, Sq, D) and
// k/v (B, H / rep, Sk, D) of `dtype` (0 float32, 1 bfloat16); lse and
// delta (B, H, Sq) float32 contiguous; q_off one device int32.  strides =
// [q, k, v, dO, dq, dk, dv] x [b, s, h] in elements, head dimension
// contiguous.  dq (B, H, Sq, D) and dk/dv (B, H, Sk, D) float32 through
// their strides.  Each launches on `stream` and returns the CUDA error
// code (0 when the launch was accepted; cudaErrorInvalidValue for D
// outside 1..256).
extern "C" int flash_bwd_dq_launch(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   const void* q_off, void* dq,
                                   const long long* strides, int B, int H,
                                   int rep, int Sq, int Sk, int D, int causal,
                                   int window, float scale, void* stream) {
  if (D < 1 || D > flash::MAX_D) return (int)cudaErrorInvalidValue;
  const flash::BwdArgs a =
      flash::make_args(strides, rep, Sq, Sk, D, causal, window, scale);
  auto s = (cudaStream_t)stream;
  if (dtype == flash::F32)
    return flash::launch_dq_d<float>(q, k, v, dout, lse, delta, q_off, dq,
                                     B, H, a, s);
  if (dtype == flash::BF16)
    return flash::launch_dq_d<__nv_bfloat16>(q, k, v, dout, lse, delta,
                                             q_off, dq, B, H, a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_bwd_dkv_launch(int dtype, const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    const void* q_off, void* dk, void* dv,
                                    const long long* strides, int B, int H,
                                    int rep, int Sq, int Sk, int D,
                                    int causal, int window, float scale,
                                    void* stream) {
  if (D < 1 || D > flash::MAX_D) return (int)cudaErrorInvalidValue;
  const flash::BwdArgs a =
      flash::make_args(strides, rep, Sq, Sk, D, causal, window, scale);
  auto s = (cudaStream_t)stream;
  if (dtype == flash::F32)
    return flash::launch_dkv_d<float>(q, k, v, dout, lse, delta, q_off, dk,
                                      dv, B, H, a, s);
  if (dtype == flash::BF16)
    return flash::launch_dkv_d<__nv_bfloat16>(q, k, v, dout, lse, delta,
                                              q_off, dk, dv, B, H, a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// ring_decode.cu - ring-buffer decode attention for NVIDIA Hopper (sm_90a),
// split over the slots (split-L).
//
// Replaces the TPU kernel repro/kernels/flash_attn/ops.py:_ring_decode_kernel
// (entry ring_decode_attention).  For every row r and head h it computes
//
//   s[j]   = (q[r, h, :] . k[r, j, h, :]) / sqrt(hd) + bias[r, j]
//   p[j]   = exp(s[j] - max_j s) / sum_j exp(s[j] - max_j s)
//   o[r,h] = sum_j p[j] * v[r, j, h, :]
//
// over the row's own ring of L slots: q (R, H, hd), k/v (R, L, H, hd),
// bias (R, L) additive (0 for a written slot, -1e9 for one not written
// yet; at least one slot of a row is valid), all float32, out (R, H, hd).
// k and v may be strided views (the scheduler passes one block's slab of
// the (rows, depth, L, H, hd) state): the kernel takes every stride and
// needs only the head dimension to be contiguous.
//
// Design.  Two kernels, one launch each per call.
//   1. ring_decode_chunk_kernel: one block of 128 threads per (chunk of
//      CHUNK = 128 slots, head, row), so (R, H, ceil(L / 128)) blocks:
//      1024 at R 4, L 2048, H 16.  Warp w takes the chunk's slots w,
//      w + 4, ...; one warp reads one slot, each lane 4 consecutive floats
//      (elements 128 c + 4 lane + e), so a slot's 512 bytes at hd = 128
//      are one coalesced load.  The loads are cp.async copies into a
//      3-stage ring of U = 2 slots of k and v a warp in shared memory,
//      lane-private (a lane reads back only what it copied), so several
//      slots a warp stay in flight while the warp computes.  Per step a
//      warp keeps an online softmax (its max m, sum l and unnormalised
//      output o); the four warps are then merged in warp order into the
//      chunk's partials m_c, l_c and o_c (hd floats).
//   2. ring_decode_merge_kernel: one block per (head, row) merges the
//      chunks in ascending chunk order: m = max m_c, w_c = exp(m_c - m)
//      (in shared memory: MAX_CHUNKS of them, hence the wrapper's
//      MAX_WINDOW), l = sum l_c w_c, out = (sum o_c w_c) / l.
// A chunk whose slots are all masked has m_c ~ -1e9, so its weight
// exp(m_c - m) is exactly 0 against a row with a valid slot.  The chunk
// size is fixed, and every sum runs in a fixed order over (row, head,
// chunk) alone, so row r of an R-row call equals a one-row call on that
// row bit for bit: the property fused in-flight decode rests on.  (A
// lane's elements are the same whether it copies them 16 bytes at a time
// or, for unaligned strides or hd % 4 != 0, 4 bytes at a time, so the
// load width changes no bit.)  The float chain: the dot is divided by
// sqrt(hd) (__fdiv_rn, not a reciprocal multiply), the bias added
// (__fadd_rn), the exponentials use expf, the output is one IEEE divide
// by l.  The file is built without --use_fast_math.  No tensor cores:
// TF32 would break the 1e-5 limit, and the work is bound by bytes.
//
// Bound on an H100 SXM: bytes.  Each call reads k and v once, 4*2*R*L*H*hd
// bytes (134 MB at R = 4, L = 2048, H = 16, hd = 128), plus q, bias and
// the output, against 3.35 TB/s: about 40 us.  The work is two
// multiply-adds per k/v element, far below the card's float32 rate.  The
// partials add 2 * 4 * R * H * ceil(L / 128) * (hd + 2) bytes (1 MB at
// that shape).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;       // slots a block; fixed, never set by R
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int U = 2;             // slots a warp computes a step
constexpr int STAGES = 3;        // steps of the cp.async ring
constexpr int MAX_CHUNKS = 96;   // merge weights in shared memory

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct RingArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;
  float* out;
  float* part_o;  // (R, H, n_chunks, hd)
  float* part_m;  // (R, H, n_chunks)
  float* part_l;  // (R, H, n_chunks)
  int L, H, hd, n_chunks, vec;
  long long q_sr, q_sh, k_sr, k_sl, k_sh, v_sr, v_sl, v_sh, b_sr, o_sr, o_sh;
  float scale;
};

// a lane's share of one slot (elements 128 c + 4 lane + e < hd) into the
// same places of `dst`, 16 bytes a copy when `vec`, else 4
template <int NC>
__device__ __forceinline__ void load_slot(float* dst, const float* src,
                                          int hd, int vec, int lane) {
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int d = 128 * c + 4 * lane;
    if (vec) {
      if (d < hd) cp_async16(dst + d, src + d);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < hd) cp_async4(dst + d + e, src + d + e);
    }
  }
}

// NC = ceil(hd / 128): a lane holds 4 * NC elements of q, k, v and o
template <int NC>
__global__ void __launch_bounds__(THREADS)
ring_decode_chunk_kernel(RingArgs a) {
  constexpr int COLS = 128 * NC;
  // the cp.async ring: [WARPS][STAGES][k, v][U][COLS]
  extern __shared__ __align__(16) float ring[];
  __shared__ float red_m[WARPS], red_l[WARPS];
  __shared__ __align__(16) float red_o[WARPS][COLS];

  const int chunk = blockIdx.x, h = blockIdx.y, r = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int hd = a.hd;
  const int j0 = chunk * CHUNK, j1 = min(j0 + CHUNK, a.L);
  const int n_w = max(0, (j1 - j0 - warp + WARPS - 1) / WARPS);
  const int n_steps = (n_w + U - 1) / U;

  const float* qr = a.q + r * a.q_sr + h * a.q_sh;
  float qv[4 * NC];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 128 * c + 4 * lane + e;
      qv[4 * c + e] = d < hd ? qr[d] : 0.0f;
    }

  const float* kr = a.k + r * a.k_sr + h * a.k_sh;
  const float* vr = a.v + r * a.v_sr + h * a.v_sh;
  const float* br = a.bias + r * a.b_sr;
  float* wring = ring + warp * STAGES * 2 * U * COLS;

  // step t: slots i = U t + u of this warp (slot j0 + warp + WARPS i)
  auto issue = [&](int t) {
    float* st = wring + (t % STAGES) * 2 * U * COLS;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = U * t + u;
      if (i < n_w) {
        const long long j = j0 + warp + WARPS * i;
        load_slot<NC>(st + u * COLS, kr + j * a.k_sl, hd, a.vec, lane);
        load_slot<NC>(st + (U + u) * COLS, vr + j * a.v_sl, hd, a.vec,
                      lane);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_steps) issue(t);
    cp_async_commit();
  }

  float m = -INFINITY, l = 0.0f, o[4 * NC];
#pragma unroll
  for (int x = 0; x < 4 * NC; ++x) o[x] = 0.0f;

  for (int t = 0; t < n_steps; ++t) {
    if (t + STAGES - 1 < n_steps) issue(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // step t's copies have landed
    const float* st = wring + (t % STAGES) * 2 * U * COLS;

    // scores: a lane's partial dot in element order, then the xor tree
    // (every lane ends with the same sum)
    float s[U];
    float m_new = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = U * t + u;
      float part = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 kk = *reinterpret_cast<const float4*>(
            st + u * COLS + 128 * c + 4 * lane);
        const float kx[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (128 * c + 4 * lane + e < hd) part += qv[4 * c + e] * kx[e];
      }
      const float dot = warp_sum(part);
      s[u] = -INFINITY;
      if (i < n_w)
        s[u] = __fadd_rn(__fdiv_rn(dot, a.scale),
                         br[j0 + warp + WARPS * i]);
      m_new = fmaxf(m_new, s[u]);
    }

    // online softmax over the warp's slots (slot U t is always present,
    // so m_new is finite)
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int x = 0; x < 4 * NC; ++x) o[x] *= corr;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (U * t + u >= n_w) continue;
      const float p = expf(s[u] - m_new);
      l += p;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            st + (U + u) * COLS + 128 * c + 4 * lane);
        const float vx[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (128 * c + 4 * lane + e < hd) o[4 * c + e] += p * vx[e];
      }
    }
    m = m_new;
    __syncwarp();  // this stage is read before a later step refills it
  }

  // the chunk's partials: the warps merged in warp order (a warp without
  // slots has m = -inf and weight 0; warp 0 always has a slot)
  if (lane == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c)
    *reinterpret_cast<float4*>(&red_o[warp][128 * c + 4 * lane]) =
        make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]);
  __syncthreads();
  float mc = red_m[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mc = fmaxf(mc, red_m[w]);
  float wt[WARPS];
#pragma unroll
  for (int w = 0; w < WARPS; ++w) wt[w] = expf(red_m[w] - mc);
  const long long p = ((long long)r * a.H + h) * a.n_chunks + chunk;
  for (int d = threadIdx.x; d < hd; d += THREADS) {
    float oc = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) oc += red_o[w][d] * wt[w];
    a.part_o[p * hd + d] = oc;
  }
  if (threadIdx.x == 0) {
    float lc = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) lc += red_l[w] * wt[w];
    a.part_m[p] = mc;
    a.part_l[p] = lc;
  }
}

__global__ void __launch_bounds__(THREADS)
ring_decode_merge_kernel(RingArgs a) {
  __shared__ float w[MAX_CHUNKS];
  const int h = blockIdx.x, r = blockIdx.y, n = a.n_chunks;
  const long long p0 = ((long long)r * a.H + h) * n;
  const float* pm = a.part_m + p0;
  const float* pl = a.part_l + p0;
  const float* po = a.part_o + p0 * a.hd;

  float m = pm[0];
  for (int c = 1; c < n; ++c) m = fmaxf(m, pm[c]);
  for (int c = threadIdx.x; c < n; c += THREADS) w[c] = expf(pm[c] - m);
  __syncthreads();
  float l = 0.0f;  // every thread sums the same chunks in the same order
  for (int c = 0; c < n; ++c) l += pl[c] * w[c];
  float* orow = a.out + r * a.o_sr + h * a.o_sh;
  for (int d = threadIdx.x; d < a.hd; d += THREADS) {
    float o = 0.0f;
    for (int c = 0; c < n; ++c) o += po[(long long)c * a.hd + d] * w[c];
    orow[d] = __fdiv_rn(o, l);
  }
}

template <int NC>
int launch(const RingArgs& a, int R, cudaStream_t stream) {
  const int smem = WARPS * STAGES * 2 * U * 128 * NC * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      ring_decode_chunk_kernel<NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  ring_decode_chunk_kernel<NC>
      <<<dim3(a.n_chunks, a.H, R), THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ring_decode_merge_kernel<<<dim3(a.H, R), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// Plain C entry point (loaded with ctypes).  `work` holds the chunk
// partials, R * H * ceil(L / 128) * (hd + 2) floats of the `work_floats`
// given.  hd <= 256 and ceil(L / 128) <= 96.  Launches the chunk and
// merge kernels on `stream` and returns 0 or the CUDA error code of the
// first that was refused (cudaErrorInvalidValue for a shape it cannot
// take or too small a `work`).
extern "C" int ring_decode_launch(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    void* work, long long work_floats, int R, int L, int H, int hd,
    long long q_sr, long long q_sh,
    long long k_sr, long long k_sl, long long k_sh, long long v_sr,
    long long v_sl, long long v_sh, long long b_sr, long long o_sr,
    long long o_sh, float scale, void* stream) {
  RingArgs a;
  a.q = (const float*)q;
  a.k = (const float*)k;
  a.v = (const float*)v;
  a.bias = (const float*)bias;
  a.out = (float*)out;
  a.L = L;
  a.H = H;
  a.hd = hd;
  a.n_chunks = (L + CHUNK - 1) / CHUNK;
  if (L < 1 || hd < 1 || hd > 256 || a.n_chunks > MAX_CHUNKS)
    return (int)cudaErrorInvalidValue;
  const long long n_part = (long long)R * H * a.n_chunks;
  if (work_floats < n_part * (hd + 2)) return (int)cudaErrorInvalidValue;
  a.part_o = (float*)work;
  a.part_m = a.part_o + n_part * hd;
  a.part_l = a.part_m + n_part;
  a.vec = hd % 4 == 0 && aligned16(k) && aligned16(v)
          && k_sr % 4 == 0 && k_sl % 4 == 0 && k_sh % 4 == 0
          && v_sr % 4 == 0 && v_sl % 4 == 0 && v_sh % 4 == 0;
  a.q_sr = q_sr;
  a.q_sh = q_sh;
  a.k_sr = k_sr;
  a.k_sl = k_sl;
  a.k_sh = k_sh;
  a.v_sr = v_sr;
  a.v_sl = v_sl;
  a.v_sh = v_sh;
  a.b_sr = b_sr;
  a.o_sr = o_sr;
  a.o_sh = o_sh;
  a.scale = scale;
  auto s = (cudaStream_t)stream;
  return hd <= 128 ? launch<1>(a, R, s) : launch<2>(a, R, s);
}

extern "C" const char* ring_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

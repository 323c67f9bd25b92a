// ring_decode.cu - ring-buffer decode attention for NVIDIA Hopper (sm_90a).
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
// Design.  One block of 128 threads per (row, head), in a fixed order.
// The four warps take slots j = warp, warp + 4, ... (loading four of them
// before reducing any); each lane holds hd/32 (rounded up) values of q,
// and a fixed-order xor-shuffle tree sums each dot.  The scores live in
// shared memory (4*L bytes, 8 KB at L = 2048).  A block max and a block
// sum, each in a fixed order, give the softmax;
// then thread t accumulates output dimension t over j in order.  Nothing
// depends on how many rows the call has, so row r of an R-row call equals
// a one-row call on that row bit for bit: the property fused in-flight
// decode rests on.  The float chain follows the JAX op order: the score is
// divided by sqrt(hd) (__fdiv_rn, not a reciprocal multiply), the bias is
// added, exp(s - max) uses expf, p = e / sum is a divide, then sum p*v.
// The file is built without --use_fast_math.
//
// Bound on an H100 SXM: bytes.  Each call reads k and v once, 4*2*R*L*H*hd
// bytes (134 MB at R = 4, L = 2048, H = 16, hd = 128), plus q, bias and
// the output, against 3.35 TB/s: about 40 us.  The work is two multiply-adds
// per k/v element, far below the card's float32 rate.  This simple design
// does not reach the bound: R*H blocks (64 at R = 4) leave half of the
// 132 SMs idle, each block streams its slots with plain loads only a few
// slots ahead (no cp.async or TMA), and the output pass reads v with one
// thread per dimension.  Splitting L across blocks (a second pass to
// merge the softmax) and cp.async/TMA double buffering are the later step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PER_LANE = 8;  // hd <= 256
constexpr int SLOTS = 4;         // slots a warp loads before reducing

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void __launch_bounds__(THREADS)
ring_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int L, int hd, long long q_sr, long long q_sh,
                   long long k_sr, long long k_sl, long long k_sh,
                   long long v_sr, long long v_sl, long long v_sh,
                   long long b_sr, long long o_sr, long long o_sh,
                   float scale) {
  extern __shared__ float s[];  // L scores, then probabilities
  __shared__ float red[WARPS];

  const int r = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const float* qr = q + r * q_sr + h * q_sh;
  float qv[MAX_PER_LANE];
#pragma unroll
  for (int c = 0; c < MAX_PER_LANE; ++c) {
    const int d = lane + 32 * c;
    qv[c] = d < hd ? qr[d] : 0.0f;
  }

  // scores: slot j belongs to warp j % WARPS, its dot summed by a fixed
  // shuffle tree; a warp loads SLOTS of its slots before reducing them,
  // which keeps loads in flight and changes no slot's arithmetic
  const float* kr = k + r * k_sr + h * k_sh;
  const float* br = bias + r * b_sr;
  for (int j0 = warp; j0 < L; j0 += SLOTS * WARPS) {
    float part[SLOTS];
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      const int j = j0 + u * WARPS;
      part[u] = 0.0f;
      if (j < L) {
        const float* kj = kr + (long long)j * k_sl;
#pragma unroll
        for (int c = 0; c < MAX_PER_LANE; ++c) {
          const int d = lane + 32 * c;
          if (d < hd) part[u] += qv[c] * kj[d];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < SLOTS; ++u) {
      const float dot = warp_sum(part[u]);  // every lane holds the sum
      const int j = j0 + u * WARPS;
      if (lane == 0 && j < L)
        s[j] = __fadd_rn(__fdiv_rn(dot, scale), br[j]);
    }
  }
  __syncthreads();

  // block max (exact in any order)
  float m = -INFINITY;
  for (int j = tid; j < L; j += THREADS) m = fmaxf(m, s[j]);
  m = warp_max(m);
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) m = fmaxf(m, red[w]);
  __syncthreads();  // red is reused below

  // exponentials and their sum, in a fixed order: each thread walks its
  // slots in order, then the shuffle tree, then the warps in order
  float sum = 0.0f;
  for (int j = tid; j < L; j += THREADS) {
    const float e = expf(__fsub_rn(s[j], m));
    s[j] = e;
    sum = __fadd_rn(sum, e);
  }
  sum = warp_sum(sum);
  if (lane == 0) red[warp] = sum;
  __syncthreads();
  sum = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) sum = __fadd_rn(sum, red[w]);
  for (int j = tid; j < L; j += THREADS) s[j] = __fdiv_rn(s[j], sum);
  __syncthreads();

  // output: thread t owns dimension t and walks the slots in order
  const float* vr = v + r * v_sr + h * v_sh;
  float* orow = out + r * o_sr + h * o_sh;
  for (int d = tid; d < hd; d += THREADS) {
    float acc = 0.0f;
    // unrolled so the loads run ahead of the in-order sum
#pragma unroll 8
    for (int j = 0; j < L; ++j) acc += s[j] * vr[(long long)j * v_sl + d];
    orow[d] = acc;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes).  Launches one block per
// (row, head) on `stream`, with 4*L bytes of dynamic shared memory, and
// returns cudaGetLastError(): non-zero when the launch was refused.
extern "C" int ring_decode_launch(
    const void* q, const void* k, const void* v, const void* bias, void* out,
    int R, int L, int H, int hd, long long q_sr, long long q_sh,
    long long k_sr, long long k_sl, long long k_sh, long long v_sr,
    long long v_sl, long long v_sh, long long b_sr, long long o_sr,
    long long o_sh, float scale, void* stream) {
  const dim3 grid(R, H);
  const size_t smem = sizeof(float) * (size_t)L;
  ring_decode_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)bias,
      (float*)out, L, hd, q_sr, q_sh, k_sr, k_sl, k_sh, v_sr, v_sl, v_sh,
      b_sr, o_sr, o_sh, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* ring_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// threefry_normal.cu - JAX's threefry normal draws, bit for bit, for
// NVIDIA Hopper (sm_90a).
//
// Computes out[s, j] = jax.random.normal(keys[s], (n,))[j] for S streams
// of n float32 each: the threefry-2x32 hash of the counter (j >> 32,
// j & 0xffffffff) under the stream's key (JAX's partitionable counter
// layout), bits1 ^ bits2, a uniform on [nextafter(-1, 0), 1) from the top
// 23 bits, and sqrt(2) * erf_inv of it.  erf_inv and its log1p are XLA's
// CPU float32 code step for step (repro_torch/core/xla_f32.py, read off
// the LLVM IR and the machine code XLA emits): a fused multiply-add where
// XLA's code has one (__fmaf_rn), a rounded multiply, add or divide
// everywhere else (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn), so that
// nvcc's default -fmad=true cannot contract what XLA rounded.
//
// Replaces no Pallas kernel: on the TPU, XLA fused jax.random.normal into
// the engine's graph (repro/runtime/engine.py:587, the noise model's
// thermal draws).  In eager PyTorch the plain version
// (repro_torch/core/prng.normal_rows) is some 250 elementwise launches over
// int64 temporaries; here one thread computes a normal in registers from
// its counter.
//
// Bound on an H100 SXM: a normal's trip through the loop below runs 230
// instructions as CUDA 12.9 compiles it, of which 168 are the normal's
// own, those its key reaches (84 on the integer / logic pipe: the threefry
// rounds, the bit moves, compares and selects; 78 on the fused
// multiply-add pipes; the reciprocal, a conversion, 4 branches), 10 more
// on erf_inv's tail side in the warps that take it; the rest are this
// layout's index, i / n divide, addresses, loop control and constants.
// chip_smoke.py's draw_trip_of reads them off `cuobjdump -sass`.  Against
// 4 bytes written, the normal's own instructions bound it: the rate at
// which the SMs start instructions, and the integer pipe's, not bytes.
// Design: a grid-stride loop over the S * n outputs, 256 threads a block,
// consecutive threads on consecutive elements of a stream (coalesced
// stores), the stream's key read once per element through the read-only
// cache.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x1, uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x1 += x2;
      x2 = rotl(x2, rot[i % 2][r]) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// XLA's CPU code flushes subnormals to zero
__device__ __forceinline__ float ftz(float x) {
  return fabsf(x) < 0x1.0p-126f ? __fmul_rn(x, 0.0f) : x;
}

// XLA CPU's float32 log (Cephes logf) of a > 0, with XLA's special values
__device__ __forceinline__ float xla_log(float a) {
  const float big = a > 0x1.0p-126f ? a : 0x1.0p-126f;
  const int ib = __float_as_int(big);
  const int e = (ib >> 23) - 127;
  const float m = __int_as_float((ib & 0x7FFFFF) | 0x3F000000);
  const float e1 = __fadd_rn(__int2float_rn(e), 1.0f);
  const bool small_m = m < 0x1.6a09e6p-1f;
  const float x = __fadd_rn(__fadd_rn(m, -1.0f), small_m ? m : 0.0f);
  const float e2 = __fsub_rn(e1, small_m ? 1.0f : 0.0f);
  const float z = __fmul_rn(x, x);
  const float z3 = __fmul_rn(z, x);
  const float p0 = __fmaf_rn(__fmaf_rn(x, 0x1.204376p-4f, -0x1.d7a37p-4f), x,
                             0x1.de4a34p-4f);
  const float p1 = __fmaf_rn(__fmaf_rn(x, -0x1.fcba9ep-4f, 0x1.23d37ep-3f), x,
                             -0x1.555cap-3f);
  const float p2 = __fmaf_rn(__fmaf_rn(x, 0x1.999d58p-3f, -0x1.fffff8p-3f), x,
                             0x1.555554p-2f);
  float p = __fmaf_rn(p0, z3, p1);
  p = __fmaf_rn(p, z3, p2);
  p = __fmaf_rn(p, z3, __fmul_rn(e2, -0x1.bd0106p-13f));
  const float r = __fmaf_rn(e2, 0x1.63p-1f,
                            __fadd_rn(p, __fmaf_rn(z, -0.5f, x)));
  if (a == 0.0f) return __int_as_float(0xFF800000);
  if (isinf(a)) return __int_as_float(0x7F800000);
  if (!(a > 0.0f)) return __int_as_float(0xFFFFFFFF);
  return r;
}

// XLA CPU's float32 log1p
__device__ __forceinline__ float xla_log1p(float x) {
  x = ftz(x);
  const float xsq = __fmul_rn(x, x);
  const float x0 = __fmul_rn(x, 0.0f);
  float den = __fadd_rn(x0, 1.0f);
  den = __fmaf_rn(den, x, 0x1.e2035ap+3f);
  den = __fmaf_rn(den, x, 0x1.4c30b6p+6f);
  den = __fmaf_rn(den, x, 0x1.bb865ap+7f);
  den = __fmaf_rn(den, x, 0x1.351946p+8f);
  den = __fmaf_rn(den, x, 0x1.b0db14p+7f);
  den = __fmaf_rn(den, x, 0x1.e0f304p+5f);
  float num = __fadd_rn(x0, 0x1.7bc096p-15f);
  num = __fmaf_rn(num, x, 0x1.fe818ap-2f);
  num = __fmaf_rn(num, x, 0x1.a509f4p+2f);
  num = __fmaf_rn(num, x, 0x1.de9738p+4f);
  num = __fmaf_rn(num, x, 0x1.e798ecp+5f);
  num = __fmaf_rn(num, x, 0x1.c8e75ap+5f);
  num = __fmaf_rn(num, x, 0x1.40a202p+4f);
  const float ratio = __fdiv_rn(num, den);
  const float small = __fadd_rn(
      x, __fmaf_rn(xsq, -0.5f, __fmul_rn(__fmul_rn(x, xsq), ratio)));
  const float large = xla_log(__fadd_rn(x, 1.0f));
  return ftz(fabsf(x) < 0x1.a8279ap-2f ? small : large);
}

// XLA's float32 erf_inv (Giles), times sqrt(2): the normal of a uniform u
__device__ __forceinline__ float xla_normal(float u) {
  u = ftz(u);
  const float lg = xla_log1p(__fmul_rn(u, -u));
  const bool lt = lg > -5.0f;
  const float w = lt ? __fsub_rn(-2.5f, lg)
                     : __fadd_rn(__fsqrt_rn(-lg), -3.0f);
  float p = __fmaf_rn(lt ? 0x1.e2cb1p-26f : -0x1.a3e136p-13f, w,
                      lt ? 0x1.70966cp-22f : 0x1.a76ad6p-14f);
  p = __fmaf_rn(w, p, lt ? -0x1.d8e6aep-19f : 0x1.61b8e4p-10f);
  p = __fmaf_rn(w, p, lt ? -0x1.26b582p-18f : -0x1.e17bcep-9f);
  p = __fmaf_rn(w, p, lt ? 0x1.ca65b6p-13f : 0x1.7824f6p-8f);
  p = __fmaf_rn(w, p, lt ? -0x1.48a81p-10f : -0x1.f38baep-8f);
  p = __fmaf_rn(w, p, lt ? -0x1.11c9dep-8f : 0x1.354afcp-7f);
  p = __fmaf_rn(w, p, lt ? 0x1.f91ec6p-3f : 0x1.006db6p+0f);
  p = __fmaf_rn(w, p, lt ? 0x1.805c5ep+0f : 0x1.6a9efcp+1f);
  if (fabsf(u) == 1.0f) p = __int_as_float(0x7F800000);
  return __fmul_rn(__fmul_rn(u, p), 0x1.6a09e6p+0f);
}

__device__ __forceinline__ float normal_of_bits(uint32_t bits) {
  constexpr float lo = -0x1.fffffep-1f;      // nextafter(-1, 0)
  const float f = __fadd_rn(__int_as_float((bits >> 9) | 0x3F800000u),
                            -1.0f);
  const float u = fmaxf(__fmaf_rn(f, 2.0f, lo), lo);
  return xla_normal(u);
}

__global__ void __launch_bounds__(THREADS)
threefry_normal_kernel(const int64_t* __restrict__ keys,
                       float* __restrict__ out, int64_t total, int64_t n) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += stride) {
    const int64_t s = i / n;
    const uint64_t j = (uint64_t)(i - s * n);
    const uint32_t k1 = (uint32_t)__ldg(keys + 2 * s);
    const uint32_t k2 = (uint32_t)__ldg(keys + 2 * s + 1);
    uint32_t x1 = (uint32_t)(j >> 32), x2 = (uint32_t)j;
    threefry2x32(k1, k2, x1, x2);
    out[i] = normal_of_bits(x1 ^ x2);
  }
}

}  // namespace

// keys: (S, 2) int64 holding uint32 words; out: (S, n) float32.
extern "C" int threefry_normal_launch(const void* keys, void* out,
                                      long long streams, long long n,
                                      void* stream) {
  if (streams < 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)streams * (int64_t)n;
  if (total == 0) return 0;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough blocks for 8 resident a SM, no more than the work needs
  int64_t blocks = (total + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)(sms > 0 ? sms : 132) * 8;
  if (blocks > cap) blocks = cap;
  threefry_normal_kernel<<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const int64_t*)keys, (float*)out, total, (int64_t)n);
  return (int)cudaGetLastError();
}

extern "C" const char* threefry_normal_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

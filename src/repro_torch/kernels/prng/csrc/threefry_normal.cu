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
// int64 temporaries; here a thread computes its normals in registers.
//
// What bounds it on an H100 SXM: instructions, not bytes.  A normal writes
// 4 bytes and runs about 137 instructions of its own (the 20 threefry
// rounds, the uniform, log1p with its IEEE divide and its log, erf_inv),
// some 66 of them on the integer / logic pipe (rotates, xors, compares),
// which runs at half the rate the SMs issue: that pipe and the issue rate
// bound it together.  chip_smoke.py's draw_trip_of counts them off
// `cuobjdump -sass`.  The first design spent 62 more instructions a normal
// on its layout (a 64-bit i / n divide, 64-bit indices, two key loads, the
// key schedule and the constants again for every normal).
//
// Design: the draw is cut into units of K = 4 consecutive normals of one
// stream, unit u = s * Q + q with Q = ceil(n / K) units a stream, so that
// short streams pack into a block as densely as long ones.  A thread takes
// a unit a trip of a grid-stride loop (a grid of as many blocks as fill the
// SMs, found once per device): it finds its stream by a multiply-high with
// a divisor the host precomputed, reads the stream's key once (one 16-byte
// load), derives the key schedule once, and runs K independent hash chains
// whose latencies overlap.  Below 2^31 units (every draw under 32 GB, so
// that u + stride cannot wrap) the loop runs on 32-bit indices;
// threefry_normal_wide_kernel takes the rest with 64-bit ones and a 64-bit
// divide.  The counter stays
// JAX's (j >> 32, j & 0xffffffff) for any n.  Where n is a multiple of K
// (the main path's draws), unit u's normals are out[K u, K u + K) and
// leave in one 16-byte store; otherwise each leaves in a scalar store, and
// those past a row's end are not stored.
//
// Dropped because no input reaches it: a normal depends only on bits >> 9,
// so it has 2^23 inputs, and on them the uniform u lies in
// [-(1 - 2^-24), 1 - 2^-23], u is never 0 or +-1, -u*u and log1p of it
// are never subnormal, and log's argument 1 - u*u lies in [2^-23, 1].  So
// the uniform's max with its lower bound, the subnormal flushes, log's
// zero / infinity / negative returns and its clamp to the least normal,
// erf_inv's |u| == 1 return and the x * 0 seeds of log1p's two
// polynomials (the seeds are constants) are left out, and the uniform,
// log's exponent and its small-mantissa fold are written as exact
// equivalents with fewer instructions.
// threefry_normal_of_bits_launch maps all 2^23 patterns through the same
// device code: chip_smoke.py holds it to the plain version on every one
// of them, bit for bit, which is what licenses these cuts.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int K = 4;  // consecutive normals a thread computes a trip
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return __funnelshift_l(x, x, d);
}

// JAX's threefry-2x32 key schedule, derived once a stream: the three key
// words and the word each round group adds to x2
struct Schedule {
  uint32_t ks[3];
  uint32_t inj[5];  // ks[(i + 2) % 3] + i + 1
};

__device__ __forceinline__ Schedule schedule_of(uint32_t k1, uint32_t k2) {
  Schedule s;
  s.ks[0] = k1;
  s.ks[1] = k2;
  s.ks[2] = k1 ^ k2 ^ 0x1BD11BDAu;
#pragma unroll
  for (int i = 0; i < 5; ++i) s.inj[i] = s.ks[(i + 2) % 3] + (uint32_t)(i + 1);
  return s;
}

// bits1 ^ bits2 of threefry-2x32 of the counter (x1, x2)
__device__ __forceinline__ uint32_t threefry_bits(const Schedule& s,
                                                  uint32_t x1, uint32_t x2) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x1 += s.ks[0];
  x2 += s.ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x1 += x2;
      x2 = rotl(x2, rot[i % 2][r]) ^ x1;
    }
    x1 += s.ks[(i + 1) % 3];
    x2 += s.inj[i];
  }
  return x1 ^ x2;
}

// XLA CPU's float32 log (Cephes logf) of a in [2^-23, 1]
__device__ __forceinline__ float xla_log(float a) {
  const int ib = __float_as_int(a);
  // the exponent plus one, (ib >> 23) - 127 + 1: a small integer, exact
  const float e1 = __int2float_rn((ib >> 23) - 126);
  const float m = __int_as_float((ib & 0x7FFFFF) | 0x3F000000);
  // 1 where m < sqrt(1/2), else 0: m * sm is exact, so the fma rounds
  // (m - 1) + (sm ? m : 0) once, as XLA's add does
  const float sm = m < 0x1.6a09e6p-1f ? 1.0f : 0.0f;
  const float x = __fmaf_rn(m, sm, __fadd_rn(m, -1.0f));
  const float e2 = __fsub_rn(e1, sm);
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
  return __fmaf_rn(e2, 0x1.63p-1f, __fadd_rn(p, __fmaf_rn(z, -0.5f, x)));
}

// XLA CPU's float32 log1p of x in [-(1 - 2^-23), -2^-48]; both sides
// computed, one selected (a warp nearly always holds both)
__device__ __forceinline__ float xla_log1p(float x) {
  const float xsq = __fmul_rn(x, x);
  // XLA seeds both polynomials with x * 0 (here -0): den's first step is
  // then 1 * x + c, num's first coefficient the constant itself
  float den = __fadd_rn(x, 0x1.e2035ap+3f);
  den = __fmaf_rn(den, x, 0x1.4c30b6p+6f);
  den = __fmaf_rn(den, x, 0x1.bb865ap+7f);
  den = __fmaf_rn(den, x, 0x1.351946p+8f);
  den = __fmaf_rn(den, x, 0x1.b0db14p+7f);
  den = __fmaf_rn(den, x, 0x1.e0f304p+5f);
  float num = __fmaf_rn(0x1.7bc096p-15f, x, 0x1.fe818ap-2f);
  num = __fmaf_rn(num, x, 0x1.a509f4p+2f);
  num = __fmaf_rn(num, x, 0x1.de9738p+4f);
  num = __fmaf_rn(num, x, 0x1.e798ecp+5f);
  num = __fmaf_rn(num, x, 0x1.c8e75ap+5f);
  num = __fmaf_rn(num, x, 0x1.40a202p+4f);
  const float ratio = __fdiv_rn(num, den);
  const float small = __fadd_rn(
      x, __fmaf_rn(xsq, -0.5f, __fmul_rn(__fmul_rn(x, xsq), ratio)));
  const float large = xla_log(__fadd_rn(x, 1.0f));
  return fabsf(x) < 0x1.a8279ap-2f ? small : large;
}

// The normals of K bit patterns (the top 23 bits of each): the uniform,
// sqrt(2) * XLA's float32 erf_inv (Giles) of it.  Written phase by phase
// over the K values so that their chains interleave.
template <int N>
__device__ __forceinline__ void normals_of_bits(const uint32_t (&bits)[N],
                                                float (&out)[N]) {
  constexpr float lo = -0x1.fffffep-1f;      // nextafter(-1, 0)
  float u[N], lg[N];
#pragma unroll
  for (int e = 0; e < N; ++e) {
    // JAX's f = float in [1, 2) from the top 23 bits, minus 1, and
    // u = fma(f, 2, lo): here the float of those bits in [2, 4), minus 2,
    // is 2f exactly, so one rounded add gives u; u >= lo, so JAX's max
    // with lo is moot
    const float f2 = __fadd_rn(
        __int_as_float((bits[e] >> 9) | 0x40000000u), -2.0f);
    u[e] = __fadd_rn(f2, lo);
    lg[e] = xla_log1p(__fmul_rn(u[e], -u[e]));
  }
#pragma unroll
  for (int e = 0; e < N; ++e) {
    // erf_inv's central side, w = -2.5 - lg, for lg > -5; the tail side
    // (w = sqrt(-lg) - 3) replaces it in the lanes that need it
    const float w = __fsub_rn(-2.5f, lg[e]);
    float p = __fmaf_rn(0x1.e2cb1p-26f, w, 0x1.70966cp-22f);
    p = __fmaf_rn(w, p, -0x1.d8e6aep-19f);
    p = __fmaf_rn(w, p, -0x1.26b582p-18f);
    p = __fmaf_rn(w, p, 0x1.ca65b6p-13f);
    p = __fmaf_rn(w, p, -0x1.48a81p-10f);
    p = __fmaf_rn(w, p, -0x1.11c9dep-8f);
    p = __fmaf_rn(w, p, 0x1.f91ec6p-3f);
    p = __fmaf_rn(w, p, 0x1.805c5ep+0f);
    if (!(lg[e] > -5.0f)) {
      const float wt = __fadd_rn(__fsqrt_rn(-lg[e]), -3.0f);
      p = __fmaf_rn(-0x1.a3e136p-13f, wt, 0x1.a76ad6p-14f);
      p = __fmaf_rn(wt, p, 0x1.61b8e4p-10f);
      p = __fmaf_rn(wt, p, -0x1.e17bcep-9f);
      p = __fmaf_rn(wt, p, 0x1.7824f6p-8f);
      p = __fmaf_rn(wt, p, -0x1.f38baep-8f);
      p = __fmaf_rn(wt, p, 0x1.354afcp-7f);
      p = __fmaf_rn(wt, p, 0x1.006db6p+0f);
      p = __fmaf_rn(wt, p, 0x1.6a9efcp+1f);
    }
    out[e] = __fmul_rn(__fmul_rn(u[e], p), 0x1.6a09e6p+0f);
  }
}

// u / d for every 32-bit u, as (t + ((u - t) >> sh1)) >> sh2 with
// t = umulhi(u, mul); kernel.py's _divider computes (mul, sh1, sh2)
struct Divider {
  uint32_t mul, sh1, sh2;
};

__device__ __forceinline__ uint32_t stream_of(uint32_t u, uint32_t,
                                              Divider d) {
  const uint32_t t = __umulhi(u, d.mul);
  return (t + ((u - t) >> d.sh1)) >> d.sh2;
}

__device__ __forceinline__ uint64_t stream_of(uint64_t u, uint64_t per_row,
                                              Divider) {
  return u / per_row;
}

// The draw's grid-stride loop over units (Index: 32-bit below 2^31 units,
// else 64-bit).  `vec`: n a multiple of K and out 16-byte aligned, so unit
// u's normals are out[K u, K u + K) and leave in one 16-byte store.
template <typename Index>
__device__ __forceinline__ void draw_units(const longlong2* __restrict__ keys,
                                           float* __restrict__ out,
                                           uint64_t n, Index per_row,
                                           Index units, Divider div,
                                           bool vec) {
  const Index stride = (Index)gridDim.x * THREADS;
  for (Index u = (Index)blockIdx.x * THREADS + threadIdx.x; u < units;
       u += stride) {
    const Index s = stream_of(u, per_row, div);
    const Index q = u - s * per_row;
    const longlong2 key = __ldg(keys + s);
    const Schedule sc = schedule_of((uint32_t)key.x, (uint32_t)key.y);
    // counter j = K q + e: q << 2 leaves the low bits for e, no carry
    const uint32_t hi = (uint32_t)((uint64_t)q >> 30);
    const uint32_t lo = (uint32_t)q << 2;
    uint32_t bits[K];
#pragma unroll
    for (int e = 0; e < K; ++e) bits[e] = threefry_bits(sc, hi, lo + e);
    float z[K];
    normals_of_bits(bits, z);
    if (vec) {
      reinterpret_cast<float4*>(out)[u] = make_float4(z[0], z[1], z[2], z[3]);
    } else {
      const uint64_t j = (uint64_t)q * K;
      float* dst = out + ((uint64_t)s * n + j);
#pragma unroll
      for (int e = 0; e < K; ++e)
        if (j + e < n) dst[e] = z[e];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
threefry_normal_kernel(const longlong2* __restrict__ keys,
                       float* __restrict__ out, uint64_t n, uint32_t per_row,
                       uint32_t units, Divider div, int vec) {
  draw_units<uint32_t>(keys, out, n, per_row, units, div, vec != 0);
}

__global__ void __launch_bounds__(THREADS)
threefry_normal_wide_kernel(const longlong2* __restrict__ keys,
                            float* __restrict__ out, uint64_t n,
                            uint64_t per_row, uint64_t units, int vec) {
  draw_units<uint64_t>(keys, out, n, per_row, units, Divider{}, vec != 0);
}

// the exhaustive check's entry: out[i] = the normal of the bit pattern
// bits[i] (low word of an int64), K patterns a thread as the draw does
__global__ void __launch_bounds__(THREADS)
normal_of_bits_kernel(const int64_t* __restrict__ bits,
                      float* __restrict__ out, int64_t count) {
  const int64_t stride = (int64_t)gridDim.x * THREADS * K;
  for (int64_t i = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * K;
       i < count; i += stride) {
    uint32_t b[K];
#pragma unroll
    for (int e = 0; e < K; ++e)
      b[e] = i + e < count ? (uint32_t)__ldg(bits + i + e) : 0u;
    float z[K];
    normals_of_bits(b, z);
#pragma unroll
    for (int e = 0; e < K; ++e)
      if (i + e < count) out[i + e] = z[e];
  }
}

// blocks of each draw kernel that fill a device's SMs, found once a device
int g_grid[2][MAX_DEVICES];

template <typename Kernel>
int draw_grid(Kernel kernel, int wide, int device, int* grid) {
  if (device < 0 || device >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (g_grid[wide][device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    g_grid[wide][device] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *grid = g_grid[wide][device];
  return 0;
}

unsigned blocks_for(uint64_t units, int grid) {
  const uint64_t need = (units + THREADS - 1) / THREADS;
  return (unsigned)(need < (uint64_t)grid ? need : grid);
}

}  // namespace

// keys: (S, 2) int64, the low word of each the key word; out: (S, n)
// float32; (mul, sh1, sh2) divide a unit index by ceil(n / 4) when
// S * ceil(n / 4) < 2^31; device: the current device's index.
extern "C" int threefry_normal_launch(const void* keys, void* out,
                                      long long streams, long long n,
                                      unsigned mul, unsigned sh1,
                                      unsigned sh2, int device,
                                      void* stream) {
  if (streams < 0 || n < 0) return (int)cudaErrorInvalidValue;
  if (streams == 0 || n == 0) return 0;
  const uint64_t per_row = ((uint64_t)n + K - 1) / K;
  const uint64_t units = (uint64_t)streams * per_row;
  const int vec = n % K == 0 && ((uintptr_t)out & 15) == 0;
  const cudaStream_t st = (cudaStream_t)stream;
  int grid = 0, err = 0;
  if (units >> 31) {
    err = draw_grid(threefry_normal_wide_kernel, 1, device, &grid);
    if (err) return err;
    threefry_normal_wide_kernel<<<blocks_for(units, grid), THREADS, 0, st>>>(
        (const longlong2*)keys, (float*)out, (uint64_t)n, per_row, units,
        vec);
  } else {
    err = draw_grid(threefry_normal_kernel, 0, device, &grid);
    if (err) return err;
    threefry_normal_kernel<<<blocks_for(units, grid), THREADS, 0, st>>>(
        (const longlong2*)keys, (float*)out, (uint64_t)n, (uint32_t)per_row,
        (uint32_t)units, Divider{mul, sh1, sh2}, vec);
  }
  return (int)cudaGetLastError();
}

// bits: count int64 bit patterns (low words); out: count float32
extern "C" int threefry_normal_of_bits_launch(const void* bits, void* out,
                                              long long count,
                                              void* stream) {
  if (count < 0) return (int)cudaErrorInvalidValue;
  if (count == 0) return 0;
  const long long per_block = (long long)THREADS * K;
  long long blocks = (count + per_block - 1) / per_block;
  if (blocks > 4096) blocks = 4096;
  normal_of_bits_kernel<<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const int64_t*)bits, (float*)out, (int64_t)count);
  return (int)cudaGetLastError();
}

extern "C" const char* threefry_normal_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

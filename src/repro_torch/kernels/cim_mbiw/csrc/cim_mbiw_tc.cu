// cim_mbiw_tc.cu - the CIM-MBIW input-serial int8 matmul with the fused
// DSCI-ADC + ABN epilogue on Hopper's int8 tensor cores (sm_90a: wgmma,
// TMA, mbarriers): route A of kernels/cim_mbiw/kernel.py, for M >= 64,
// K >= 32 with K a multiple of 16, and one or two input planes.  It serves
// LeNet's conv2 and fc layers at batch 256, the full-macro tile and the
// FMA canary.
//
// Replaces the TPU kernel repro/kernels/cim_mbiw/kernel.py:_cim_mbiw_kernel
// (entry cim_mbiw_matmul_planes) on those shapes, with its function:
//
//   dp[m, n]   = sum_p 2^(plane_shift*p) * sum_k x[m, p*K + k] * w[k, n]
//   code[m, n] = clip(floor((mid + f32(f32(gamma[n]*g0) * f32(dp))) + beta),
//                     0, 2^r_out - 1)
//
// with beta per column (1, N) or per GEMM row (M, N), or the raw int32 dp
// when fuse_adc == 0.  Bit for bit: the products are exact int8 x int8
// sums in the tensor cores' int32 accumulators (no .satfinite, so they
// wrap like the TPU's int32 adds), and the epilogue rounds step by step
// (cim_epilogue.cuh).
//
// Design.  One block per BM x BN output tile (BM 64 or 128, BN 16, 32, 64
// or 128, both template parameters chosen from the shape): a producer
// warpgroup and BM / 64 consumer warpgroups of 64 rows.  K walks in stages
// of 128 int8 values (one 128-byte swizzled row a tile row) through a
// 4-stage shared-memory ring with full/empty mbarriers:
//   - x: one thread of the producer loads each plane's BM x 128 box by TMA
//     from a 3-d map (K, P, M), so a box past K reads zeros, never the
//     next plane; TMA needs K % 16 == 0 (the plane and row strides);
//   - w: int8 wgmma takes both operands K-major only, and w arrives
//     (K, N) with N contiguous.  The 128 producer threads transpose each
//     128 x BN weight stage on its way in: 16-byte loads of four weight
//     rows, byte permutes (prmt) into words of four k at one n, 4-byte
//     stores into the swizzled K-major tile (byte loads where N is not a
//     multiple of 16), then fence.proxy.async before they arrive, so that
//     wgmma's async proxy sees the stores.
// A consumer runs, per stage and per k-step of 32, one
// wgmma.m64nBNk32.s32.s8.s8 per plane from shared memory; the weight stage
// serves both planes.  Each plane keeps its own accumulator (BN / 2
// registers), combined as acc0 + (acc1 << shift) mod 2^32 in the
// epilogue.  The planes (1 or 2) are a template parameter, and BN stops at
// 128 for one plane and 64 for two, so that the accumulators take at most
// 64 registers a thread and the block needs no setmaxnreg (which blocks
// for good when the registers it asks for were never allocated).  The
// consumer keeps one wgmma group in flight and frees a stage when the next
// one's products are issued.  The grid walks the N tiles of an M tile
// together, so their x boxes come from L2.
// Descriptors: K-major, 128-byte swizzle, SBO 1024 (the next 8 rows), a
// k-step of 32 bytes starts 32 bytes further (flash_tc.cuh's arithmetic
// for a bf16 k16 step).  Accumulator layout: flash_tc.cuh's, int32 in
// place of float; the epilogue masks the ragged M/N edges.
//
// Registers: at BM 128 the block has 384 threads, 168 registers each.
//
// Bound on an H100 SXM: at the full-macro tile (M 16384, K 1152, N 256,
// P 2) the bytes (37.7 MB of x, 16.8 MB of codes: 0.016 ms) and the int8
// work (19.3 GOP: 0.010 ms at 1979 TOP/s) are close; LeNet's conv2 and
// fc tiles are bound by their bytes.

#include "../../flash_attn/csrc/flash_tc.cuh"
#include "cim_epilogue.cuh"

namespace cim {
namespace tcr {
namespace {

using flash::tc::desc_sw128;
using flash::tc::fence_regs;
using flash::tc::mbar_arrive;
using flash::tc::mbar_arrive_tx;
using flash::tc::mbar_fence_init;
using flash::tc::mbar_init;
using flash::tc::smem_u32;
using flash::tc::wgmma_commit;
using flash::tc::wgmma_fence;

constexpr int WG = 128;             // threads in a warpgroup
constexpr int BK = 128;             // K values (bytes) a stage
constexpr int STAGES = 4;           // depth of the ring
constexpr int MAX_PLANES = 2;

template <int BM, int BN>
struct TcSmem {
  uint8_t x[STAGES][MAX_PLANES][BM * BK];  // K-major, swizzled by TMA
  uint8_t w[STAGES][BN * BK];              // K-major, swizzled by hand
  uint64_t full[STAGES], empty[STAGES];
};

struct TcArgs {
  const int8_t* w;
  const float* gamma;
  const float* beta;
  int32_t* out;
  int M, N, K, P, plane_shift, beta_rows, wvec;
  Adc adc;
};

// one box of a 3-d tensor map into shared memory, completing its bytes on
// `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// make this thread's generic-proxy shared-memory stores visible to the
// async proxy (wgmma reads the weight tile through it)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// byte offset of (row, k) in a K-major tile of 128-byte rows with the
// 128-byte swizzle (16-byte chunk c of row r sits at chunk c ^ (r % 8);
// the tile starts on a 1024-byte boundary)
__device__ __forceinline__ int swz(int row, int k) {
  return row * BK + ((((k >> 4) ^ row) & 7) << 4) + (k & 15);
}

// wait until the phase of parity `parity` of `bar` has completed, or give
// up after about 2^32 clock cycles (a few seconds): a fault then shows as
// wrong codes, which the callers' checks catch, instead of a kernel that
// never ends.  No trap: an exit path on the consumer side keeps ptxas from
// applying setmaxnreg.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done && clock64() - t0 < (1ll << 32));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// d[64 x 16] += a[64 x 32] . b[32 x 16]: s8 x s8 -> s32, a and b
// K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[8], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}"
      ", %8, %9, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 32] += a[64 x 32] . b[32 x 32]: s8 x s8 -> s32, a and b
// K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[16], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
      ", %16, %17, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 64] += a[64 x 32] . b[32 x 64]: s8 x s8 -> s32, a and b
// K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}"
      ", %32, %33, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d[64 x 128] += a[64 x 32] . b[32 x 128]: s8 x s8 -> s32, a and b
// K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// weights [k0, k0 + 128) x [n0, n0 + BN) of w (K, N) into a K-major
// swizzled stage; zeros past K and N.  Run by the 128 producer threads.
template <int BN>
__device__ __forceinline__ void load_weights(uint8_t* dst, const TcArgs& a,
                                             int k0, int n0, int tid) {
  if (a.wvec) {
    // a unit is four k (kq) x 16 columns (nc): four 16-byte row loads,
    // then a 4 x 4 byte transpose per 4-column word.  A warp covers one
    // column piece and all 32 kq, so its stores fill whole 128-byte rows
    for (int u = tid; u < 32 * (BN / 16); u += WG) {
      const int kq = u % 32, nc = u / 32;
      const int gk = k0 + 4 * kq, gn = n0 + 16 * nc;
      uint4 r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = gk + i < a.K && gn < a.N
                   ? __ldg(reinterpret_cast<const uint4*>(
                         a.w + (size_t)(gk + i) * a.N + gn))
                   : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // rows k..k+3 of columns 4j..4j+3 -> columns of four k
        const uint32_t lo01 = __byte_perm(word(r[0], j), word(r[1], j),
                                          0x5140);
        const uint32_t hi01 = __byte_perm(word(r[0], j), word(r[1], j),
                                          0x7362);
        const uint32_t lo23 = __byte_perm(word(r[2], j), word(r[3], j),
                                          0x5140);
        const uint32_t hi23 = __byte_perm(word(r[2], j), word(r[3], j),
                                          0x7362);
        const uint32_t c[4] = {__byte_perm(lo01, lo23, 0x5410),
                               __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410),
                               __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
        for (int b = 0; b < 4; ++b)
          *reinterpret_cast<uint32_t*>(dst + swz(16 * nc + 4 * j + b,
                                                 4 * kq)) = c[b];
      }
    }
  } else {
    for (int u = tid; u < 32 * BN; u += WG) {
      const int kq = u % 32, n = u / 32;
      const int gk = k0 + 4 * kq, gn = n0 + n;
      uint32_t v = 0u;
      if (gn < a.N) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (gk + e < a.K)
            v |= (uint32_t)(uint8_t)a.w[(size_t)(gk + e) * a.N + gn]
                 << (8 * e);
      }
      *reinterpret_cast<uint32_t*>(dst + swz(n, 4 * kq)) = v;
    }
  }
}

template <int BM, int BN, int P>
__global__ void __launch_bounds__((BM / 64 + 1) * WG, 1)
cim_mbiw_tc_kernel(const __grid_constant__ CUtensorMap tmx, TcArgs a) {
  constexpr int NWG = BM / 64;  // consumer warpgroups
  static_assert(P * BN <= 128, "accumulators over 64 registers a thread");
  extern __shared__ uint8_t smem_raw[];
  TcSmem<BM, BN>& sm = *reinterpret_cast<TcSmem<BM, BN>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_kt = (a.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // the TMA thread's expect_tx arrival + every producer thread's
      // arrival after its weight stores
      mbar_init(&sm.full[s], WG + 1);
      mbar_init(&sm.empty[s], NWG * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  const int tid = threadIdx.x % WG;
  if (wg == 0) {
    // -- producer ---------------------------------------------------------
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&sm.empty[s], ((kt / STAGES) & 1) ^ 1);
      if (tid == 0) {
        mbar_arrive_tx(&sm.full[s], (uint32_t)(P * BM * BK));
        for (int p = 0; p < P; ++p)
          tma_load_3d(&sm.x[s][p][0], &tmx, &sm.full[s], kt * BK, p, m0);
      }
      load_weights<BN>(&sm.w[s][0], a, kt * BK, n0, tid);
      fence_proxy_async();
      mbar_arrive(&sm.full[s]);
    }
  } else {
    // -- consumers: 64 rows each ------------------------------------------
    const int cw = wg - 1;
    // acc1 is one unused register with one plane
    uint32_t acc0[BN / 2], acc1[P == 2 ? BN / 2 : 1];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc0[i] = 0u;
#pragma unroll
    for (int i = 0; i < (P == 2 ? BN / 2 : 1); ++i) acc1[i] = 0u;

    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&sm.full[s], (kt / STAGES) & 1);
      fence_regs(acc0);
      fence_regs(acc1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk) {
        const uint64_t db = desc_sw128(&sm.w[s][32 * kk], 16, 1024);
        wgmma_s8(acc0, desc_sw128(&sm.x[s][0][64 * cw * BK + 32 * kk], 16,
                                  1024), db);
        if constexpr (P == 2)
          wgmma_s8(acc1, desc_sw128(&sm.x[s][1][64 * cw * BK + 32 * kk], 16,
                                    1024), db);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      fence_regs(acc0);
      fence_regs(acc1);
      if (kt > 0) mbar_arrive(&sm.empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc0);
    fence_regs(acc1);

    // warp w, lane l hold rows 16 w + l / 4 (+ 8), columns 8 j + 2 (l % 4)
    // (+ 1): values 4 j + 2 ri + c
    const int warp = tid / 32, lane = tid % 32;
    const int row0 = m0 + 64 * cw + 16 * warp + lane / 4;
    const uint32_t shift = (uint32_t)a.plane_shift;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = n0 + 8 * j + 2 * (lane % 4) + c;
        if (col >= a.N) continue;
        const float g = a.gamma[col];
#pragma unroll
        for (int ri = 0; ri < 2; ++ri) {
          const int row = row0 + 8 * ri;
          if (row >= a.M) continue;
          const int i = 4 * j + 2 * ri + c;
          uint32_t dp = acc0[i];
          if constexpr (P == 2) dp += acc1[i] << shift;
          a.out[(size_t)row * a.N + col] = adc_code(
              a.adc, (int32_t)dp, g,
              beta_at(a.beta, a.beta_rows, row, col, a.N));
        }
      }
  }
}

// x (M, P*K) int8 as a 3-d map (K, P, M): boxes of 128 x 1 x BM bytes with
// the 128-byte swizzle, zeros past K and M.  Returns 0 or an error code
// (CU_ERROR_BASE + CUresult).
int make_x_map(CUtensorMap* map, const void* x, int M, int K, int P,
               int bm) {
  flash::tc::EncodeTiled fn = flash::tc::encode_tiled();
  if (!fn) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)K, (cuuint64_t)P, (cuuint64_t)M};
  const cuuint64_t strides[2] = {(cuuint64_t)K, (cuuint64_t)P * K};
  const cuuint32_t box[3] = {(cuuint32_t)BK, 1, (cuuint32_t)bm};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
                        const_cast<void*>(x), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : flash::tc::CU_ERROR_BASE + (int)r;
}

template <int BM, int BN, int P>
int launch(const void* x, const TcArgs& a, cudaStream_t stream) {
  CUtensorMap tmx;
  const int err = make_x_map(&tmx, x, a.M, a.K, P, BM);
  if (err) return err;
  const size_t smem = sizeof(TcSmem<BM, BN>) + 1024;
  // once per instantiation (not again while a CUDA graph captures)
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        cim_mbiw_tc_kernel<BM, BN, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM);
  cim_mbiw_tc_kernel<BM, BN, P><<<grid, (BM / 64 + 1) * WG, smem, stream>>>(
      tmx, a);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_bn(int bn, const void* x, const TcArgs& a, cudaStream_t s) {
  if (a.P == 1) {
    switch (bn) {
      case 16: return launch<BM, 16, 1>(x, a, s);
      case 32: return launch<BM, 32, 1>(x, a, s);
      case 64: return launch<BM, 64, 1>(x, a, s);
      case 128: return launch<BM, 128, 1>(x, a, s);
    }
  } else {
    switch (bn) {
      case 16: return launch<BM, 16, 2>(x, a, s);
      case 32: return launch<BM, 32, 2>(x, a, s);
      case 64: return launch<BM, 64, 2>(x, a, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace tcr
}  // namespace cim

// Plain C entry point (loaded with ctypes): x (M, P*K) int8, 16-byte
// aligned, K a multiple of 16, P 1 or 2; w (K, N) int8; gamma (1, N) and
// beta (1, N) or (M, N) float32; out (M, N) int32; all contiguous.  bm 64
// or 128 and bn 16, 32, 64 or (one plane) 128 are the tile; wvec 1 when
// N % 16 == 0 and w is 16-byte aligned.  Launches on `stream` and returns 0, a CUDA
// error code, or 100000 + a CUresult when the tensor map cannot be built.
extern "C" int cim_mbiw_tc_launch(const void* x, const void* w,
                                  const void* gamma, const void* beta,
                                  void* out, int M, int N, int K, int P,
                                  int plane_shift, float g0, int r_out,
                                  int fuse_adc, int beta_rows, int bm,
                                  int bn, int wvec, void* stream) {
  if (P < 1 || P > cim::tcr::MAX_PLANES || K % 16 != 0 || M < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  cim::tcr::TcArgs a;
  a.w = (const int8_t*)w;
  a.gamma = (const float*)gamma;
  a.beta = (const float*)beta;
  a.out = (int32_t*)out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.P = P;
  a.plane_shift = plane_shift;
  a.beta_rows = beta_rows;
  a.wvec = wvec;
  a.adc = cim::make_adc(g0, r_out, fuse_adc);
  auto s = (cudaStream_t)stream;
  if (bm == 64) return cim::tcr::launch_bn<64>(bn, x, a, s);
  if (bm == 128) return cim::tcr::launch_bn<128>(bn, x, a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cim_mbiw_tc_error_string(int err) {
  return flash::tc::error_string(err);
}

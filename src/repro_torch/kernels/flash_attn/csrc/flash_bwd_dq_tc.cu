// flash_bwd_dq_tc.cu - dq of flash attention on Hopper's tensor cores
// (sm_90a: wgmma, TMA, mbarriers), for bfloat16 inputs at D = 64, 128 or
// 256 (D 256: its own kernel, flash_bwd_dq_tc_d256_kernel below).
//
// Replaces the TPU kernel
// repro/kernels/flash_attn/kernel.py:_flash_bwd_dq_kernel for the train
// path's type; flash_bwd.cu keeps float32 inputs and other head
// dimensions.  In float32 and in the JAX kernel's order (the dot first,
// then the scale):
//
//   s[i, j]  = scale * (q[i] . k[j])
//   p[i, j]  = exp(s[i, j] - lse[i])  where the mask keeps (i, j), else 0
//   ds[i, j] = p[i, j] * (dO[i] . v[j] - delta[i]) * scale
//   dq[i]    = sum_j ds[i, j] k[j]                       (float32 out)
//
// The split.  dS is float32; rounded to bf16 once it would cost up to
// 2^-9 of each term of dq, outside the 5e-5 limit (the cases of
// tests/test_torch_flash_split.py).  So it goes to the tensor cores as
// two bf16 pieces, hi = bf16(ds) and lo = bf16(ds - hi): dQ += dS_hi K +
// dS_lo K, leaving at most 2^-18 of each term.  Four tensor-core passes
// instead of three.
//
// Design: the mirror of flash_bwd_dkv_tc.cu.  One block of 384 threads
// per (128-row query tile, head, batch): a producer warpgroup (one thread
// issues the TMA loads, setmaxnreg 24) and two consumer warpgroups of 64
// query rows each (setmaxnreg 240).  Q and dO load once; K and V tiles of
// 64 keys stream through a 2-stage ring (full/empty mbarriers); each
// consumer reads lse and delta of its two rows a thread into registers
// once.  Per key tile a consumer runs
//   S = Q K^T and dP = dO V^T   wgmma m64n64k16 from shared memory (Q, dO,
//                               K, V K-major); S as two chains over the
//                               halves of D added in float32, as accurate
//                               as a float32 GEMM (a single chain is not,
//                               and p = exp(s - lse) turns an error in s
//                               into a relative error in p);
//   P, dS                       in registers (__fmul_rn(scale, s), expf),
//                               then dS split into its pieces;
//   dQ += dS_hi K + dS_lo K     wgmma with A from registers and K
//                               MN-major from the same tile.
// 64-key tiles keep S, its second half-chain, dP (32 values each) and the
// D-wide dQ accumulator (64 at D = 128) under the 240 registers; 128-key
// tiles would not fit.  The key tiles start at the first one the window
// keeps and end at the last one the causal mask keeps; the tiles skipped
// have p = 0 exactly.  Every sum runs in a fixed order and nothing is
// added atomically, so a call repeats bit for bit.  Rows past Sq are not
// stored; keys past Sk read as zeros and get p = 0.  At D 256 the
// accumulator and the tiles do not fit this design; the D 256 kernel
// (below) takes 64 rows a block and splits D between its warpgroups, with
// dS through shared memory.
//
// Registers and shared memory (ptxas, CUDA 12.9): 168 registers a thread
// at entry, then setmaxnreg gives the consumers 240 and the producer 24;
// no spill (0-byte stack frame) at D 64, 128 and 256.  Dynamic shared
// memory 66,600 bytes at D 64, 132,136 at D 128 and 214,056 at D 256 (Q
// and dO 2 x 32 KB, K and V 2 stages x 64 KB, the pieces 2 x 8 KB) of the
// 232,448 a block may opt in to: one block an SM (ptxas and the library's
// flash_bwd_dq_tc_smem_bytes, in chip_smoke.py's build phase).
//
// Bound on an H100 SXM: operations.  At B 2, H 16, S 4096, D 128, causal,
// the three products over the kept pairs are 206 GFLOP, 0.21 ms at the
// bf16 tensor-core rate (the split's fourth pass is the kernel's own
// cost, not counted); the bytes take under 0.05 ms.  At
// recurrentgemma-2b's B 1, H 10, G 1, S 4096, D 256, causal, window 2048:
// 0.0977 ms (operations).

#include "flash_tc.cuh"

namespace flash {
namespace tc {
namespace {

constexpr int DQ_BQ = 128;  // query rows a block (64 a consumer)
constexpr int DQ_BK = 64;   // keys a streamed tile

template <int D>
struct DqSmem {
  __nv_bfloat16 q[D / 64][DQ_BQ][64];
  __nv_bfloat16 dout[D / 64][DQ_BQ][64];
  __nv_bfloat16 k[STAGES][D / 64][DQ_BK][64];
  __nv_bfloat16 v[STAGES][D / 64][DQ_BK][64];
  uint64_t q_full, full[STAGES], empty[STAGES];
};

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(DqSmem<D>) + 1024;  // + room to align the base to 1024
}

struct DqArgs {
  const float* lse;
  const float* delta;
  const int* q_off;
  float* dq;
  Strides sdq;
  int H, rep, Sq, Sk, causal, window;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tdo, DqArgs a) {
  extern __shared__ uint8_t smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q0 = blockIdx.x * DQ_BQ;
  const int h = blockIdx.y, b = blockIdx.z, g = h / a.rep;
  const int q_off = *a.q_off;

  // key tiles to visit: a window needs q_off + i - j < window (the first
  // row bounds it), causal needs q_off + i >= j (the last row bounds it)
  const int n_kt = (a.Sk + DQ_BK - 1) / DQ_BK;
  const int last_row = min(q0 + DQ_BQ, a.Sq) - 1;
  int kt0 = 0, kt1 = n_kt;
  if (a.window > 0) kt0 = max(0, q_off + q0 - a.window + 1) / DQ_BK;
  if (a.causal)
    kt1 = max(0, min(n_kt, floor_div(q_off + last_row, DQ_BK) + 1));

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // -- producer: one thread issues every load --------------------------
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(&sm.q_full, 2 * DQ_BQ * D * 2);
      tma_tile<D>(&sm.q[0][0][0], DQ_BQ, &tq, &sm.q_full, q0, h, b);
      tma_tile<D>(&sm.dout[0][0][0], DQ_BQ, &tdo, &sm.q_full, q0, h, b);
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_tx(&sm.full[s], 2 * DQ_BK * D * 2);
        tma_tile<D>(&sm.k[s][0][0][0], DQ_BK, &tk, &sm.full[s],
                    kt * DQ_BK, g, b);
        tma_tile<D>(&sm.v[s][0][0][0], DQ_BK, &tv, &sm.full[s],
                    kt * DQ_BK, g, b);
      }
    }
  } else {
    // -- consumers: 64 query rows each ------------------------------------
    regs_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG, lane = tid % 32;
    const int t = lane % 4;
    const int row0 = q0 + 64 * cw + 16 * (tid / 32) + lane / 4;  // and +8
    const long long stat0 = ((long long)b * a.H + h) * a.Sq;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = row0 + 8 * ri;
      lse_r[ri] = r < a.Sq ? a.lse[stat0 + r] : 0.0f;
      delta_r[ri] = r < a.Sq ? a.delta[stat0 + r] : 0.0f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

    mbar_wait(&sm.q_full, 0);
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int s = i % STAGES;
      const int k0 = kt * DQ_BK;
      mbar_wait(&sm.full[s], (i / STAGES) & 1);

      // S = Q K^T (two half-D chains) and dP = dO V^T, 64 x 64 float32
      float sc[DQ_BK / 2], sc_hi[DQ_BK / 2], dp[DQ_BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        wgmma_ss(sc, desc_k(&sm.q[0][0][0], DQ_BQ, 64 * cw, kk),
                 desc_k(&sm.k[s][0][0][0], DQ_BK, 0, kk), kk > 0);
#pragma unroll
      for (int kk = D / 32; kk < D / 16; ++kk)
        wgmma_ss(sc_hi, desc_k(&sm.q[0][0][0], DQ_BQ, 64 * cw, kk),
                 desc_k(&sm.k[s][0][0][0], DQ_BK, 0, kk), kk > D / 32);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc_k(&sm.dout[0][0][0], DQ_BQ, 64 * cw, kk),
                 desc_k(&sm.v[s][0][0][0], DQ_BK, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(sc_hi);
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < DQ_BK / 2; ++e) sc[e] += sc_hi[e];

      // dS in place of dP; value 4 j + 2 ri + c is row row0 + 8 ri, key
      // k0 + 8 j + 2 t + c
#pragma unroll
      for (int j = 0; j < DQ_BK / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kp = k0 + 8 * j + 2 * t + c;
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {
            const int r = row0 + 8 * ri;
            const float x = sc[4 * j + 2 * ri + c];
            float& y = dp[4 * j + 2 * ri + c];
            float p = 0.0f;
            if (r < a.Sq && kp < a.Sk
                && keep(q_off + r, kp, a.causal, a.window))
              p = expf(__fmul_rn(a.scale, x) - lse_r[ri]);
            y = p * (y - delta_r[ri]) * a.scale;
          }
        }

      // the pieces, as A fragments: k-step i is values 8 i .. 8 i + 7
      uint32_t ds_hi[DQ_BK / 4], ds_lo[DQ_BK / 4];
#pragma unroll
      for (int e = 0; e < DQ_BK / 4; ++e)
        split2(dp[2 * e], dp[2 * e + 1], ds_hi[e], ds_lo[e]);

      // dQ += dS_hi K + dS_lo K
      fence_regs(acc);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk)
        wgmma_rs(acc, &ds_hi[4 * kk], desc_mn(&sm.k[s][0][0][0], DQ_BK, kk));
#pragma unroll
      for (int kk = 0; kk < DQ_BK / 16; ++kk)
        wgmma_rs(acc, &ds_lo[4 * kk], desc_mn(&sm.k[s][0][0][0], DQ_BK, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      mbar_arrive(&sm.empty[s]);
    }

    // dq (float32); rows past Sq are not stored
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = row0 + 8 * ri;
      if (r >= a.Sq) continue;
      float* qrow = a.dq + b * a.sdq.b + (long long)r * a.sdq.s
                    + h * a.sdq.h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(qrow + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * ri], acc[4 * j + 2 * ri + 1]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const long long* st, int B, int G, const DqArgs& a,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, B, a.Sq, a.H, D, Strides{st[0], st[1], st[2]},
                     DQ_BQ);
  if (!err)
    err = make_map(&tk, k, B, a.Sk, G, D, Strides{st[3], st[4], st[5]},
                   DQ_BK);
  if (!err)
    err = make_map(&tv, v, B, a.Sk, G, D, Strides{st[6], st[7], st[8]},
                   DQ_BK);
  if (!err)
    err = make_map(&tdo, dout, B, a.Sq, a.H, D,
                   Strides{st[9], st[10], st[11]}, DQ_BQ);
  if (err) return err;
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + DQ_BQ - 1) / DQ_BQ, a.H, B);
  flash_bwd_dq_tc_kernel<D><<<grid, THREADS, smem, stream>>>(tq, tk, tv, tdo,
                                                             a);
  return (int)cudaGetLastError();
}

// -- D 256 ------------------------------------------------------------------
//
// At D 256 a warpgroup that owned 64 query rows would hold 64 x 256 of dQ,
// 128 float registers a thread beside S, its second half-chain and dP, and
// 128-row Q and dO tiles with two K/V stages would take 256 KB.  So a block
// takes 64 query rows, and its two consumer warpgroups split the keys for
// the scores (keys 32 w .. 32 w + 31 of each 64-key tile) and D for the
// accumulator (columns 128 w .. 128 w + 127 of dQ: 64 registers): each
// forms S = Q K^T and dP = dO V^T for the tile's 64 rows and its 32 keys
// (wgmma m64n32k16 over the whole of D; S as two chains over the halves of
// D, added in float32, as at D 128), then P and dS in float32.  The hi/lo
// pieces of dS go to shared memory as (query, key) tiles under the 128-byte
// swizzle; after a named barrier both warpgroups read all 64 keys of them,
// K-major, as wgmma's A operand, with the K tile MN-major as B: dQ +=
// dS_hi K + dS_lo K over their own columns (m64n128k16).  A second barrier
// keeps a warpgroup from overwriting the pieces while the other still
// reads them.

constexpr int DQ256_BQ = 64;  // query rows a block
constexpr int DQ256_BK = 64;  // keys a streamed tile

struct Dq256Smem {
  __nv_bfloat16 q[4][DQ256_BQ][64];
  __nv_bfloat16 dout[4][DQ256_BQ][64];
  __nv_bfloat16 k[STAGES][4][DQ256_BK][64];
  __nv_bfloat16 v[STAGES][4][DQ256_BK][64];
  // the current tile's pieces of dS, row = query, column = key
  __nv_bfloat16 ds_hi[DQ256_BQ][64], ds_lo[DQ256_BQ][64];
  uint64_t q_full, full[STAGES], empty[STAGES];
};

constexpr size_t dq256_smem_bytes() {
  return sizeof(Dq256Smem) + 1024;  // + room to align the base to 1024
}
static_assert(dq256_smem_bytes() <= 232448,
              "the D 256 tiles outgrow the shared memory a block may use");

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_tc_d256_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            DqArgs a) {
  constexpr int D = 256, BQ = DQ256_BQ, BK = DQ256_BK;
  extern __shared__ uint8_t smem_raw[];
  Dq256Smem& sm = *reinterpret_cast<Dq256Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z, g = h / a.rep;
  const int q_off = *a.q_off;

  // key tiles to visit, as in the D <= 128 kernel
  const int n_kt = (a.Sk + BK - 1) / BK;
  const int last_row = min(q0 + BQ, a.Sq) - 1;
  int kt0 = 0, kt1 = n_kt;
  if (a.window > 0) kt0 = max(0, q_off + q0 - a.window + 1) / BK;
  if (a.causal) kt1 = max(0, min(n_kt, floor_div(q_off + last_row, BK) + 1));

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 2 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // -- producer: one thread issues every load --------------------------
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(&sm.q_full, 2 * BQ * D * 2);
      tma_tile<D>(&sm.q[0][0][0], BQ, &tq, &sm.q_full, q0, h, b);
      tma_tile<D>(&sm.dout[0][0][0], BQ, &tdo, &sm.q_full, q0, h, b);
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_tx(&sm.full[s], 2 * BK * D * 2);
        tma_tile<D>(&sm.k[s][0][0][0], BK, &tk, &sm.full[s], kt * BK, g, b);
        tma_tile<D>(&sm.v[s][0][0][0], BK, &tv, &sm.full[s], kt * BK, g, b);
      }
    }
  } else {
    // -- consumers: keys 32 cw .. for S and dP, columns 128 cw .. for dQ --
    regs_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG, lane = tid % 32;
    const int t = lane % 4;
    const int row = 16 * (tid / 32) + lane / 4;  // and +8: a query row of
                                                 // S, dP and dQ
    const int kcol = 32 * cw;                    // S's first key
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = q0 + row + 8 * ri;
      const long long at = ((long long)b * a.H + h) * a.Sq + r;
      lse_r[ri] = r < a.Sq ? a.lse[at] : 0.0f;
      delta_r[ri] = r < a.Sq ? a.delta[at] : 0.0f;
    }

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

    mbar_wait(&sm.q_full, 0);
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int s = i % STAGES;
      const int k0 = kt * BK;
      mbar_wait(&sm.full[s], (i / STAGES) & 1);

      // S = Q K^T and dP = dO V^T (64 rows x this warpgroup's 32 keys)
      float sc[16], sc_hi[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        wgmma_ss(sc, desc_k(&sm.q[0][0][0], BQ, 0, kk),
                 desc_k(&sm.k[s][0][0][0], BK, kcol, kk), kk > 0);
#pragma unroll
      for (int kk = D / 32; kk < D / 16; ++kk)
        wgmma_ss(sc_hi, desc_k(&sm.q[0][0][0], BQ, 0, kk),
                 desc_k(&sm.k[s][0][0][0], BK, kcol, kk), kk > D / 32);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc_k(&sm.dout[0][0][0], BQ, 0, kk),
                 desc_k(&sm.v[s][0][0][0], BK, kcol, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(sc_hi);
      fence_regs(dp);

      // dS in place of dP; value 4 j + 2 ri + c is row q0 + row + 8 ri,
      // key k0 + kcol + 8 j + 2 t + c
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int r = q0 + row + 8 * ri;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * ri + c;
            const int kp = k0 + kcol + 8 * j + 2 * t + c;
            float p = 0.0f;
            if (r < a.Sq && kp < a.Sk
                && keep(q_off + r, kp, a.causal, a.window))
              p = expf(__fmul_rn(a.scale, sc[e] + sc_hi[e]) - lse_r[ri]);
            dp[e] = p * (dp[e] - delta_r[ri]) * a.scale;
          }
      }

      // the other warpgroup has read the last tile's pieces; write these
      bar_sync(PIECES_BAR, 2 * WG);
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * j + 2 * ri;
          store_pieces(sm.ds_hi, sm.ds_lo, row + 8 * ri, kcol + 8 * j + 2 * t,
                       dp[e], dp[e + 1]);
        }
      fence_proxy_async();
      bar_sync(PIECES_BAR, 2 * WG);

      // dQ += dS_hi K + dS_lo K over columns 128 cw .. 128 cw + 127: dS
      // K-major, K MN-major
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_mn<0>(acc, desc_k(&sm.ds_hi[0][0], BQ, 0, kk),
                       desc_mn(&sm.k[s][2 * cw][0][0], BK, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_ss_mn<0>(acc, desc_k(&sm.ds_lo[0][0], BQ, 0, kk),
                       desc_mn(&sm.k[s][2 * cw][0][0], BK, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(&sm.empty[s]);
    }

    // dq (float32) of rows q0 + row, + 8, columns 128 cw ..; rows past Sq
    // are not stored
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = q0 + row + 8 * ri;
      if (r >= a.Sq) continue;
      float* qrow = a.dq + b * a.sdq.b + (long long)r * a.sdq.s
                    + h * a.sdq.h + 128 * cw;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(qrow + 8 * j + 2 * t) =
            make_float2(acc[4 * j + 2 * ri], acc[4 * j + 2 * ri + 1]);
    }
  }
}

int launch_d256(const void* q, const void* k, const void* v, const void* dout,
                const long long* st, int B, int G, const DqArgs& a,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, B, a.Sq, a.H, 256, Strides{st[0], st[1], st[2]},
                     DQ256_BQ);
  if (!err)
    err = make_map(&tk, k, B, a.Sk, G, 256, Strides{st[3], st[4], st[5]},
                   DQ256_BK);
  if (!err)
    err = make_map(&tv, v, B, a.Sk, G, 256, Strides{st[6], st[7], st[8]},
                   DQ256_BK);
  if (!err)
    err = make_map(&tdo, dout, B, a.Sq, a.H, 256,
                   Strides{st[9], st[10], st[11]}, DQ256_BQ);
  if (err) return err;
  const size_t smem = dq256_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_tc_d256_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + DQ256_BQ - 1) / DQ256_BQ, a.H, B);
  flash_bwd_dq_tc_d256_kernel<<<grid, THREADS, smem, stream>>>(tq, tk, tv,
                                                               tdo, a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tc
}  // namespace flash

// Plain C entry point (loaded with ctypes).  q, dO (B, H, Sq, D) and k/v
// (B, H / rep, Sk, D) bfloat16, D 64, 128 or 256, through the strides st =
// [q, k, v, dO, dq] x [b, s, h] (elements, head dimension contiguous; the
// bf16 operands' strides multiples of 8 and their pointers 16-byte
// aligned, as TMA needs); lse and delta (B, H, Sq) float32 contiguous;
// q_off one device int32; dq (B, H, Sq, D) float32 through its strides
// (even, 8-byte aligned).  Launches on `stream` and returns 0, a CUDA
// error code, or 100000 + a CUresult when a tensor map cannot be built.
extern "C" int flash_bwd_dq_tc_launch(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      const void* q_off, void* dq,
                                      const long long* st, int B, int H,
                                      int rep, int Sq, int Sk, int D,
                                      int causal, int window, float scale,
                                      void* stream) {
  flash::tc::DqArgs a;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.q_off = (const int*)q_off;
  a.dq = (float*)dq;
  a.sdq = flash::Strides{st[12], st[13], st[14]};
  a.H = H;
  a.rep = rep;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  auto s = (cudaStream_t)stream;
  if (D == 64)
    return flash::tc::launch<64>(q, k, v, dout, st, B, H / rep, a, s);
  if (D == 128)
    return flash::tc::launch<128>(q, k, v, dout, st, B, H / rep, a, s);
  if (D == 256)
    return flash::tc::launch_d256(q, k, v, dout, st, B, H / rep, a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_bwd_dq_tc_error_string(int err) {
  return flash::tc::error_string(err);
}

// Dynamic shared memory a block takes at head dim D (0 for another D).
extern "C" int flash_bwd_dq_tc_smem_bytes(int D) {
  if (D == 64) return (int)flash::tc::dq_smem_bytes<64>();
  if (D == 128) return (int)flash::tc::dq_smem_bytes<128>();
  if (D == 256) return (int)flash::tc::dq256_smem_bytes();
  return 0;
}

// flash_bwd_dkv_tc.cu - dk and dv of flash attention on Hopper's tensor
// cores (sm_90a: wgmma, TMA, mbarriers), for bfloat16 inputs at D = 64,
// 128 or 256 (D 256: its own kernel, flash_bwd_dkv_tc_d256_kernel below).
//
// Replaces the TPU kernel
// repro/kernels/flash_attn/kernel.py:_flash_bwd_dkv_kernel for the train
// path's type (dq: flash_bwd_dq_tc.cu); flash_bwd.cu keeps float32
// inputs and other head dimensions.  Per query head (the caller sums
// each kv group's rep heads), in float32 and in the JAX kernel's order
// (the dot first, then the scale):
//
//   s[i, j]  = scale * (q[i] . k[j])
//   p[i, j]  = exp(s[i, j] - lse[i])  where the mask keeps (i, j), else 0
//   ds[i, j] = p[i, j] * (dO[i] . v[j] - delta[i]) * scale
//   dv[j]    = sum_i p[i, j] dO[i],   dk[j] = sum_i ds[i, j] q[i]
//
// The split.  p and ds are float32; rounded to bf16 once they would cost
// up to 2^-9 of each term, 1e-3 to 5.5e-3 on dk and dv against a 5e-5
// limit (the cases of tests/test_torch_flash_split.py).  So each goes to the tensor cores as two bf16 pieces, hi =
// bf16(x) and lo = bf16(x - hi): dv += P^T_hi dO + P^T_lo dO and dk +=
// dS^T_hi Q + dS^T_lo Q, leaving at most 2^-18 of each term.  Six
// tensor-core passes instead of four.
//
// Design.  One block of 384 threads per (128-key tile, query head,
// batch): a producer warpgroup (one warp issues the loads, setmaxnreg 24)
// and two consumer warpgroups of 64 keys each (setmaxnreg 240).  K and V
// load once; Q and dO tiles of 64 rows stream through a 2-stage TMA ring,
// lse and delta beside them (the producer warp copies them to shared
// memory and arrives on the same barrier).  Computed transposed, so that
// P and dS land in registers as the next product's A fragments:
//   S^T = K Q^T and dP^T = V dO^T   wgmma m64n64k16, both from shared
//                                   memory (Q and dO K-major);
//   P^T, dS^T                       in registers, then split;
//   dV += P^T dO, dK += dS^T Q      wgmma with A from registers and dO, Q
//                                   MN-major from the same tiles.
// The query tiles start at the first one the causal mask keeps and end at
// the last one the window keeps; the tiles skipped have p = 0 exactly.
// Every sum runs in a fixed order and nothing is added atomically, so a
// call repeats bit for bit.  Keys past Sk are not stored; rows past Sq
// read as zeros and get p = 0.  S^T runs as two wgmma chains over the
// halves of D, added in float32 (see the loop), as accurate as a float32
// GEMM.
//
// Registers and shared memory (ptxas, CUDA 12.9): 168 registers a thread
// at entry, then setmaxnreg gives the consumers 240 and the producer 24.
// At D = 128 the consumers still spill (a 136-byte stack frame; ptxas
// counts 524 bytes of spill stores in the code) and ptxas serializes some
// wgmmas; at D = 64 nothing spills.  Dynamic shared memory 133,160 bytes
// at D = 128 (K and V 64 KB, Q and dO 2 x 32 KB) and 67,624 at D = 64: one
// block an SM.  The D 256 kernel: 168 registers at entry, the same
// setmaxnreg budgets, no spill (0-byte stack frame); dynamic shared memory
// 231,464 bytes (K and V 64 KB, Q and dO 2 x 64 KB, the pieces 4 x 8 KB,
// lse and delta 1 KB) of the 232,448 a block may opt in to (ptxas and the
// library's flash_bwd_dkv_tc_smem_bytes, CUDA 12.9, in chip_smoke.py's
// build phase).
//
// Bound on an H100 SXM: operations.  At B 2, H 16, S 4096, D 128, causal,
// the four products over the kept pairs are 275 GFLOP, 0.278 ms at the
// bf16 tensor-core rate (the split's two extra passes are the kernel's
// own cost, not counted); the bytes take under 0.06 ms.  At
// recurrentgemma-2b's B 1, H 10, G 1, S 4096, D 256, causal, window 2048:
// 0.130 ms (operations).

#include "flash_tc.cuh"

namespace flash {
namespace tc {
namespace {

constexpr int DKV_BK = 128;  // keys a block (64 a consumer)
constexpr int DKV_BQ = 64;   // query rows a streamed tile

template <int D>
struct DkvSmem {
  __nv_bfloat16 k[D / 64][DKV_BK][64];
  __nv_bfloat16 v[D / 64][DKV_BK][64];
  __nv_bfloat16 q[STAGES][D / 64][DKV_BQ][64];
  __nv_bfloat16 dout[STAGES][D / 64][DKV_BQ][64];
  float lse[STAGES][DKV_BQ], delta[STAGES][DKV_BQ];
  uint64_t kv_full, full[STAGES], empty[STAGES];
};

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(DkvSmem<D>) + 1024;  // + room to align the base to 1024
}

struct DkvArgs {
  const float* lse;
  const float* delta;
  const int* q_off;
  float* dk;
  float* dv;
  Strides sdk, sdv;
  int H, rep, Sq, Sk, causal, window;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, DkvArgs a) {
  extern __shared__ uint8_t smem_raw[];
  DkvSmem<D>& sm = *reinterpret_cast<DkvSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int k0 = blockIdx.x * DKV_BK;
  const int h = blockIdx.y, b = blockIdx.z, g = h / a.rep;
  const int q_off = *a.q_off;
  const long long stat0 = ((long long)b * a.H + h) * a.Sq;

  // query tiles to visit: causal needs q_off + i >= j, a window needs
  // q_off + i - j < window
  const int n_qt = (a.Sq + DKV_BQ - 1) / DKV_BQ;
  const int last_key = min(k0 + DKV_BK, a.Sk) - 1;
  int qt0 = 0, qt1 = n_qt;
  if (a.causal) qt0 = min(n_qt, max(0, k0 - q_off) / DKV_BQ);
  if (a.window > 0)
    qt1 = max(0, min(n_qt, floor_div(last_key + a.window - 1 - q_off,
                                     DKV_BQ) + 1));

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);      // the producer warp's lanes
      mbar_init(&sm.empty[s], 2 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // -- producer: warp 0 ----------------------------------------------------
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_tx(&sm.kv_full, 2 * DKV_BK * D * 2);
        tma_tile<D>(&sm.k[0][0][0], DKV_BK, &tk, &sm.kv_full, k0, g, b);
        tma_tile<D>(&sm.v[0][0][0], DKV_BK, &tv, &sm.kv_full, k0, g, b);
      }
      for (int qt = qt0, i = 0; qt < qt1; ++qt, ++i) {
        const int s = i % STAGES;
        const int r0 = qt * DKV_BQ;
        mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);
#pragma unroll
        for (int e = 0; e < DKV_BQ / 32; ++e) {
          const int r = r0 + lane + 32 * e;
          sm.lse[s][lane + 32 * e] = r < a.Sq ? a.lse[stat0 + r] : 0.0f;
          sm.delta[s][lane + 32 * e] = r < a.Sq ? a.delta[stat0 + r] : 0.0f;
        }
        if (lane == 0) {
          mbar_arrive_tx(&sm.full[s], 2 * DKV_BQ * D * 2);
          tma_tile<D>(&sm.q[s][0][0][0], DKV_BQ, &tq, &sm.full[s], r0, h, b);
          tma_tile<D>(&sm.dout[s][0][0][0], DKV_BQ, &tdo, &sm.full[s], r0, h,
                      b);
        } else {
          mbar_arrive(&sm.full[s]);  // releases this lane's lse/delta
        }
      }
    }
  } else {
    // -- consumers: 64 keys each -------------------------------------------
    regs_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG, lane = tid % 32;
    const int t = lane % 4;
    const int key0 = k0 + 64 * cw + 16 * (tid / 32) + lane / 4;  // and +8

    float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

    mbar_wait(&sm.kv_full, 0);
    for (int qt = qt0, i = 0; qt < qt1; ++qt, ++i) {
      const int s = i % STAGES;
      const int r0 = qt * DKV_BQ;
      mbar_wait(&sm.full[s], (i / STAGES) & 1);

      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries), float32.
      // S^T runs as two chains over the halves of D, added in float32: a
      // wgmma chain of D / 16 steps sums q . k less accurately than a
      // float32 GEMM, two half chains as accurately or better, and p =
      // exp(s - lse) turns an error in s into a relative error in p
      float st[DKV_BQ / 2], st_hi[DKV_BQ / 2], dpt[DKV_BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        wgmma_ss(st, desc_k(&sm.k[0][0][0], DKV_BK, 64 * cw, kk),
                 desc_k(&sm.q[s][0][0][0], DKV_BQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = D / 32; kk < D / 16; ++kk)
        wgmma_ss(st_hi, desc_k(&sm.k[0][0][0], DKV_BK, 64 * cw, kk),
                 desc_k(&sm.q[s][0][0][0], DKV_BQ, 0, kk), kk > D / 32);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dpt, desc_k(&sm.v[0][0][0], DKV_BK, 64 * cw, kk),
                 desc_k(&sm.dout[s][0][0][0], DKV_BQ, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(st_hi);
      fence_regs(dpt);
#pragma unroll
      for (int e = 0; e < DKV_BQ / 2; ++e) st[e] += st_hi[e];

      // P^T and dS^T in place; value 4 j + 2 ri + c is key key0 + 8 ri,
      // query r0 + 8 j + 2 t + c
#pragma unroll
      for (int j = 0; j < DKV_BQ / 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = 8 * j + 2 * t + c;
          const int r = r0 + col;
          const float lse_r = sm.lse[s][col], delta_r = sm.delta[s][col];
#pragma unroll
          for (int ri = 0; ri < 2; ++ri) {
            const int kp = key0 + 8 * ri;
            float& x = st[4 * j + 2 * ri + c];
            float& y = dpt[4 * j + 2 * ri + c];
            float p = 0.0f;
            if (r < a.Sq && kp < a.Sk
                && keep(q_off + r, kp, a.causal, a.window))
              p = expf(__fmul_rn(a.scale, x) - lse_r);
            x = p;
            y = p * (y - delta_r) * a.scale;
          }
        }

      // the pieces, as A fragments: k-step i is values 8 i .. 8 i + 7
      uint32_t p_hi[DKV_BQ / 4], p_lo[DKV_BQ / 4];
      uint32_t ds_hi[DKV_BQ / 4], ds_lo[DKV_BQ / 4];
#pragma unroll
      for (int e = 0; e < DKV_BQ / 4; ++e) {
        split2(st[2 * e], st[2 * e + 1], p_hi[e], p_lo[e]);
        split2(dpt[2 * e], dpt[2 * e + 1], ds_hi[e], ds_lo[e]);
      }

      // dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(p_hi);
      fence_regs(p_lo);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        wgmma_rs(acc_dv, &p_hi[4 * kk],
                 desc_mn(&sm.dout[s][0][0][0], DKV_BQ, kk));
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        wgmma_rs(acc_dv, &p_lo[4 * kk],
                 desc_mn(&sm.dout[s][0][0][0], DKV_BQ, kk));
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        wgmma_rs(acc_dk, &ds_hi[4 * kk],
                 desc_mn(&sm.q[s][0][0][0], DKV_BQ, kk));
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        wgmma_rs(acc_dk, &ds_lo[4 * kk],
                 desc_mn(&sm.q[s][0][0][0], DKV_BQ, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(p_hi);
      fence_regs(p_lo);
      fence_regs(ds_hi);
      fence_regs(ds_lo);
      mbar_arrive(&sm.empty[s]);
    }

    // dk, dv (float32); keys past Sk are not stored
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int kp = key0 + 8 * ri;
      if (kp >= a.Sk) continue;
      float* krow = a.dk + b * a.sdk.b + (long long)kp * a.sdk.s
                    + h * a.sdk.h;
      float* vrow = a.dv + b * a.sdv.b + (long long)kp * a.sdv.s
                    + h * a.sdv.h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(krow + 8 * j + 2 * t) =
            make_float2(acc_dk[4 * j + 2 * ri], acc_dk[4 * j + 2 * ri + 1]);
        *reinterpret_cast<float2*>(vrow + 8 * j + 2 * t) =
            make_float2(acc_dv[4 * j + 2 * ri], acc_dv[4 * j + 2 * ri + 1]);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const long long* st, int B, int G, const DkvArgs& a,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, B, a.Sq, a.H, D, Strides{st[0], st[1], st[2]},
                     DKV_BQ);
  if (!err)
    err = make_map(&tk, k, B, a.Sk, G, D, Strides{st[3], st[4], st[5]},
                   DKV_BK);
  if (!err)
    err = make_map(&tv, v, B, a.Sk, G, D, Strides{st[6], st[7], st[8]},
                   DKV_BK);
  if (!err)
    err = make_map(&tdo, dout, B, a.Sq, a.H, D,
                   Strides{st[9], st[10], st[11]}, DKV_BQ);
  if (err) return err;
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sk + DKV_BK - 1) / DKV_BK, a.H, B);
  flash_bwd_dkv_tc_kernel<D><<<grid, THREADS, smem, stream>>>(tq, tk, tv,
                                                               tdo, a);
  return (int)cudaGetLastError();
}

// -- D 256 ------------------------------------------------------------------
//
// At D 256 a warpgroup that owned 64 keys would hold 64 x 256 of both dK and
// dV, 256 float registers a thread.  So a block takes 64 keys, and its two
// consumer warpgroups split D for the accumulators (columns 128 w ..
// 128 w + 127 of dK and dV: 64 + 64 registers) and the keys for the scores
// (keys 32 w .. 32 w + 31): each forms S = Q K^T and dP = dO V^T for the
// tile's 64 query rows and its 32 keys (wgmma m64n32k16 over the whole of
// D; S as two chains over the halves of D, added in float32, as at D 128),
// then P and dS in float32.  The hi/lo pieces of P and dS go to shared
// memory as (query, key) tiles under the 128-byte swizzle; after a named
// barrier both warpgroups read all 64 keys of them, MN-major, as wgmma's A
// operand: dV += P^T dO and dK += dS^T Q over their own columns (m64n128k16,
// A and B both from shared memory).  A second barrier keeps a warpgroup
// from overwriting the pieces while the other still reads them.

constexpr int DKV256_BK = 64;  // keys a block
constexpr int DKV256_BQ = 64;  // query rows a streamed tile

struct Dkv256Smem {
  __nv_bfloat16 k[4][DKV256_BK][64];
  __nv_bfloat16 v[4][DKV256_BK][64];
  __nv_bfloat16 q[STAGES][4][DKV256_BQ][64];
  __nv_bfloat16 dout[STAGES][4][DKV256_BQ][64];
  // the current tile's pieces, row = query, column = key
  __nv_bfloat16 p_hi[DKV256_BQ][64], p_lo[DKV256_BQ][64];
  __nv_bfloat16 ds_hi[DKV256_BQ][64], ds_lo[DKV256_BQ][64];
  float lse[STAGES][DKV256_BQ], delta[STAGES][DKV256_BQ];
  uint64_t kv_full, full[STAGES], empty[STAGES];
};

constexpr size_t dkv256_smem_bytes() {
  return sizeof(Dkv256Smem) + 1024;  // + room to align the base to 1024
}
static_assert(dkv256_smem_bytes() <= 232448,
              "the D 256 tiles outgrow the shared memory a block may use");

__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_tc_d256_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             DkvArgs a) {
  constexpr int D = 256, BK = DKV256_BK, BQ = DKV256_BQ;
  extern __shared__ uint8_t smem_raw[];
  Dkv256Smem& sm = *reinterpret_cast<Dkv256Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z, g = h / a.rep;
  const int q_off = *a.q_off;
  const long long stat0 = ((long long)b * a.H + h) * a.Sq;

  // query tiles to visit, as in the D <= 128 kernel
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int last_key = min(k0 + BK, a.Sk) - 1;
  int qt0 = 0, qt1 = n_qt;
  if (a.causal) qt0 = min(n_qt, max(0, k0 - q_off) / BQ);
  if (a.window > 0)
    qt1 = max(0, min(n_qt, floor_div(last_key + a.window - 1 - q_off, BQ)
                               + 1));

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);      // the producer warp's lanes
      mbar_init(&sm.empty[s], 2 * WG);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // -- producer: warp 0 ----------------------------------------------------
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_tx(&sm.kv_full, 2 * BK * D * 2);
        tma_tile<D>(&sm.k[0][0][0], BK, &tk, &sm.kv_full, k0, g, b);
        tma_tile<D>(&sm.v[0][0][0], BK, &tv, &sm.kv_full, k0, g, b);
      }
      for (int qt = qt0, i = 0; qt < qt1; ++qt, ++i) {
        const int s = i % STAGES;
        const int r0 = qt * BQ;
        mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);
#pragma unroll
        for (int e = 0; e < BQ / 32; ++e) {
          const int r = r0 + lane + 32 * e;
          sm.lse[s][lane + 32 * e] = r < a.Sq ? a.lse[stat0 + r] : 0.0f;
          sm.delta[s][lane + 32 * e] = r < a.Sq ? a.delta[stat0 + r] : 0.0f;
        }
        if (lane == 0) {
          mbar_arrive_tx(&sm.full[s], 2 * BQ * D * 2);
          tma_tile<D>(&sm.q[s][0][0][0], BQ, &tq, &sm.full[s], r0, h, b);
          tma_tile<D>(&sm.dout[s][0][0][0], BQ, &tdo, &sm.full[s], r0, h, b);
        } else {
          mbar_arrive(&sm.full[s]);  // releases this lane's lse/delta
        }
      }
    }
  } else {
    // -- consumers: keys 32 cw .. for S and dP, columns 128 cw .. for dK, dV
    regs_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG, lane = tid % 32;
    const int t = lane % 4;
    const int row = 16 * (tid / 32) + lane / 4;  // and +8: a query row of S,
                                                 // a key row of dK and dV
    const int kcol = 32 * cw;                    // S's first key

    float acc_dk[64], acc_dv[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

    mbar_wait(&sm.kv_full, 0);
    for (int qt = qt0, i = 0; qt < qt1; ++qt, ++i) {
      const int s = i % STAGES;
      const int r0 = qt * BQ;
      mbar_wait(&sm.full[s], (i / STAGES) & 1);

      // S = Q K^T and dP = dO V^T (64 queries x this warpgroup's 32 keys)
      float st[16], st_hi[16], dp[16];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk)
        wgmma_ss(st, desc_k(&sm.q[s][0][0][0], BQ, 0, kk),
                 desc_k(&sm.k[0][0][0], BK, kcol, kk), kk > 0);
#pragma unroll
      for (int kk = D / 32; kk < D / 16; ++kk)
        wgmma_ss(st_hi, desc_k(&sm.q[s][0][0][0], BQ, 0, kk),
                 desc_k(&sm.k[0][0][0], BK, kcol, kk), kk > D / 32);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc_k(&sm.dout[s][0][0][0], BQ, 0, kk),
                 desc_k(&sm.v[0][0][0], BK, kcol, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(st_hi);
      fence_regs(dp);

      // P and dS in place; value 4 j + 2 ri + c is query r0 + row + 8 ri,
      // key k0 + kcol + 8 j + 2 t + c
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int r = r0 + row + 8 * ri;
        const float lse_r = sm.lse[s][row + 8 * ri];
        const float delta_r = sm.delta[s][row + 8 * ri];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 4 * j + 2 * ri + c;
            const int kp = k0 + kcol + 8 * j + 2 * t + c;
            float p = 0.0f;
            if (r < a.Sq && kp < a.Sk
                && keep(q_off + r, kp, a.causal, a.window))
              p = expf(__fmul_rn(a.scale, st[e] + st_hi[e]) - lse_r);
            st[e] = p;
            dp[e] = p * (dp[e] - delta_r) * a.scale;
          }
      }

      // the other warpgroup has read the last tile's pieces; write these
      bar_sync(PIECES_BAR, 2 * WG);
#pragma unroll
      for (int ri = 0; ri < 2; ++ri)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = 4 * j + 2 * ri;
          const int col = kcol + 8 * j + 2 * t;
          store_pieces(sm.p_hi, sm.p_lo, row + 8 * ri, col, st[e],
                       st[e + 1]);
          store_pieces(sm.ds_hi, sm.ds_lo, row + 8 * ri, col, dp[e],
                       dp[e + 1]);
        }
      fence_proxy_async();
      bar_sync(PIECES_BAR, 2 * WG);

      // dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q over
      // columns 128 cw .. 128 cw + 127
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_ss_mn(acc_dv, desc_mn(&sm.p_hi[0][0], BQ, kk),
                    desc_mn(&sm.dout[s][2 * cw][0][0], BQ, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_ss_mn(acc_dv, desc_mn(&sm.p_lo[0][0], BQ, kk),
                    desc_mn(&sm.dout[s][2 * cw][0][0], BQ, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_ss_mn(acc_dk, desc_mn(&sm.ds_hi[0][0], BQ, kk),
                    desc_mn(&sm.q[s][2 * cw][0][0], BQ, kk), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_ss_mn(acc_dk, desc_mn(&sm.ds_lo[0][0], BQ, kk),
                    desc_mn(&sm.q[s][2 * cw][0][0], BQ, kk), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      mbar_arrive(&sm.empty[s]);
    }

    // dk, dv (float32) of keys k0 + row, + 8, columns 128 cw ..; keys past
    // Sk are not stored
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int kp = k0 + row + 8 * ri;
      if (kp >= a.Sk) continue;
      float* krow = a.dk + b * a.sdk.b + (long long)kp * a.sdk.s
                    + h * a.sdk.h + 128 * cw;
      float* vrow = a.dv + b * a.sdv.b + (long long)kp * a.sdv.s
                    + h * a.sdv.h + 128 * cw;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<float2*>(krow + 8 * j + 2 * t) =
            make_float2(acc_dk[4 * j + 2 * ri], acc_dk[4 * j + 2 * ri + 1]);
        *reinterpret_cast<float2*>(vrow + 8 * j + 2 * t) =
            make_float2(acc_dv[4 * j + 2 * ri], acc_dv[4 * j + 2 * ri + 1]);
      }
    }
  }
}

int launch_d256(const void* q, const void* k, const void* v, const void* dout,
                const long long* st, int B, int G, const DkvArgs& a,
                cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, B, a.Sq, a.H, 256, Strides{st[0], st[1], st[2]},
                     DKV256_BQ);
  if (!err)
    err = make_map(&tk, k, B, a.Sk, G, 256, Strides{st[3], st[4], st[5]},
                   DKV256_BK);
  if (!err)
    err = make_map(&tv, v, B, a.Sk, G, 256, Strides{st[6], st[7], st[8]},
                   DKV256_BK);
  if (!err)
    err = make_map(&tdo, dout, B, a.Sq, a.H, 256,
                   Strides{st[9], st[10], st[11]}, DKV256_BQ);
  if (err) return err;
  const size_t smem = dkv256_smem_bytes();
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_d256_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sk + DKV256_BK - 1) / DKV256_BK, a.H, B);
  flash_bwd_dkv_tc_d256_kernel<<<grid, THREADS, smem, stream>>>(tq, tk, tv,
                                                                tdo, a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tc
}  // namespace flash

// Plain C entry point (loaded with ctypes).  q, dO (B, H, Sq, D) and k/v
// (B, H / rep, Sk, D) bfloat16, D 64, 128 or 256, through the strides st =
// [q, k, v, dO, dk, dv] x [b, s, h] (elements, head dimension contiguous;
// the bf16 operands' strides multiples of 8 and their pointers 16-byte
// aligned, as TMA needs); lse and delta (B, H, Sq) float32 contiguous;
// q_off one device int32; dk, dv (B, H, Sk, D) float32 through their
// strides (even, 8-byte aligned).  Launches on `stream` and returns 0, a
// CUDA error code, or 100000 + a CUresult when a tensor map cannot be
// built.
extern "C" int flash_bwd_dkv_tc_launch(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       const void* q_off, void* dk, void* dv,
                                       const long long* st, int B, int H,
                                       int rep, int Sq, int Sk, int D,
                                       int causal, int window, float scale,
                                       void* stream) {
  flash::tc::DkvArgs a;
  a.lse = (const float*)lse;
  a.delta = (const float*)delta;
  a.q_off = (const int*)q_off;
  a.dk = (float*)dk;
  a.dv = (float*)dv;
  a.sdk = flash::Strides{st[12], st[13], st[14]};
  a.sdv = flash::Strides{st[15], st[16], st[17]};
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

extern "C" const char* flash_bwd_dkv_tc_error_string(int err) {
  return flash::tc::error_string(err);
}

// Dynamic shared memory a block takes at head dim D (0 for another D).
extern "C" int flash_bwd_dkv_tc_smem_bytes(int D) {
  if (D == 64) return (int)flash::tc::dkv_smem_bytes<64>();
  if (D == 128) return (int)flash::tc::dkv_smem_bytes<128>();
  if (D == 256) return (int)flash::tc::dkv256_smem_bytes();
  return 0;
}

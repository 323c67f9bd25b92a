// flash_fwd_tc.cu - flash attention forward on Hopper's tensor cores
// (sm_90a: wgmma, TMA, mbarriers), for bfloat16 inputs at D = 64, 128 or
// 256.
//
// Replaces the TPU kernel repro/kernels/flash_attn/kernel.py:_flash_kernel
// (entry flash_attention_bhsd) for the train path's type; flash_fwd.cu
// keeps float32 inputs and other head dimensions.  For batch b, query
// head h and its kv head g = h / rep it computes, in float32,
//
//   s[i, j] = scale * (q[i] . k[j])           (scale = 1 / sqrt(D))
//   s[i, j] = -1e30 where the mask drops (i, j); -inf for j >= Sk
//   O[i]    = sum_j exp(s[i, j] - m_i) v[j] / max(l_i, 1e-30)   (bf16 out)
//   lse[i]  = m_i + log(max(l_i, 1e-30))
//
// by the online softmax, with the mask and the ragged edges of
// flash_fwd.cu.  The JAX kernel scales q before the product; here the
// bf16 x bf16 product is exact in float32 and the scale comes after it,
// which moves s by one float32 rounding (far inside the 2e-5 limit).
//
// The split.  P = exp(s - m) is float32 and cannot be rounded to bf16
// once: that costs up to 2^-9 of each term, 6e-4 to 2.7e-3 on O against a
// 2e-5 limit (the cases of tests/test_torch_flash_split.py).  So P
// goes to the tensor cores as two bf16 pieces, hi = bf16(P) and lo =
// bf16(P - hi), and O += P_hi . V + P_lo . V; what is left, at most 2^-18
// of each term, is below float32 noise on O.  The forward is three
// tensor-core passes (Q K^T, P_hi V, P_lo V) instead of two.
//
// Design.  One block of 384 threads per (128-row query tile, head,
// batch): a producer warpgroup (one thread issues every TMA load, setmaxnreg
// 24) and two consumer warpgroups of 64 query rows each (setmaxnreg 240).
// Q loads once; K and V tiles of 128 keys stream through a 2-stage ring
// (full/empty mbarriers).  A consumer runs S = Q K^T as wgmma m64n128k16
// from shared memory, the softmax in registers (a row's max and sum over
// the 4 threads of a quad), splits P in registers and runs P . V as wgmma
// with A from registers and V MN-major from shared memory.  Key tiles the
// mask drops for every row are skipped when every row of the tile keeps a
// key (as in flash_fwd.cu).
//
// At D 256 the key tile is 64 (fwd_bk): 128-key stages would take 256 KB
// of shared memory, and a consumer's 128 O accumulators leave no room for
// a 64 x 128 S and its pieces.  S = Q K^T is then wgmma m64n64k16 over 16
// k-steps (S 32 registers, P hi/lo 16 + 16), and O += P V one m64n256k16
// chain a piece.  The sums, the split and the mask rules are those of D
// 128; under recurrentgemma's 2048 window a block visits at most 34 of
// the 64 key tiles of S 4096.
//
// Registers and shared memory (ptxas, CUDA 12.9): 168 registers a thread
// at entry, then setmaxnreg gives the consumers 240 and the producer 24;
// no spills at D 64, 128 or 256.  Dynamic shared memory 164,904 bytes at
// D = 128 (Q 32 KB, K and V 2 x 64 KB), 82,984 at D = 64 and 197,672 at
// D = 256 (Q 64 KB, 64-key K and V 2 x 64 KB), so one block runs on an
// SM.
//
// Bound on an H100 SXM: operations.  At B 2, H 16, S 4096, D 128, causal,
// the two products over the kept pairs are 137 GFLOP, 0.139 ms at the
// bf16 tensor-core rate (the split's third pass is the kernel's own cost,
// not counted); the 67 MB of q/k/v/O take 0.02 ms.  At recurrentgemma-2b's
// B 1, H 10, G 1, S 4096, D 256, causal, window 2048: 0.065 ms.

#include "flash_tc.cuh"

namespace flash {
namespace tc {
namespace {

constexpr int FWD_BQ = 128;  // query rows a block (64 a consumer)

// keys a tile: 128, and 64 at D 256, where two stages of 128-key K and V
// tiles would take 256 KB and a consumer's S and P pieces (64 + 64
// registers) would not fit beside its 128 O accumulators
template <int D>
__host__ __device__ constexpr int fwd_bk() {
  return D == 256 ? 64 : 128;
}

template <int D>
struct FwdSmem {
  __nv_bfloat16 q[D / 64][FWD_BQ][64];
  __nv_bfloat16 k[STAGES][D / 64][fwd_bk<D>()][64];
  __nv_bfloat16 v[STAGES][D / 64][fwd_bk<D>()][64];
  uint64_t q_full, full[STAGES], empty[STAGES];
};

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(FwdSmem<D>) + 1024;  // + room to align the base to 1024
}

struct FwdArgs {
  __nv_bfloat16* o;
  float* lse;
  const int* q_off;
  Strides so;
  int H, rep, Sq, Sk, causal, window;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, FwdArgs a) {
  constexpr int FWD_BK = fwd_bk<D>();
  extern __shared__ uint8_t smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q0 = blockIdx.x * FWD_BQ;
  const int h = blockIdx.y, b = blockIdx.z, g = h / a.rep;
  const int q_off = *a.q_off;

  // key tiles to visit (every thread computes the same range): skip those
  // the mask drops for every row, unless a row of this tile keeps no key
  const int n_kt = (a.Sk + FWD_BK - 1) / FWD_BK;
  const int last_row = min(q0 + FWD_BQ, a.Sq) - 1;
  bool every_row_keeps = true;
  for (int r = q0; r <= last_row; ++r) {
    const int qp = q_off + r;
    const int lo = a.window > 0 ? max(0, qp - a.window + 1) : 0;
    const int hi = a.causal ? min(a.Sk - 1, qp) : a.Sk - 1;
    every_row_keeps = every_row_keeps && lo <= hi;
  }
  int kt0 = 0, kt1 = n_kt;
  if (every_row_keeps) {
    if (a.window > 0) kt0 = max(0, q_off + q0 - a.window + 1) / FWD_BK;
    if (a.causal) kt1 = min(n_kt, (q_off + last_row) / FWD_BK + 1);
  }

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
      mbar_arrive_tx(&sm.q_full, FWD_BQ * D * 2);
      tma_tile<D>(&sm.q[0][0][0], FWD_BQ, &tq, &sm.q_full, q0, h, b);
      for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
        const int s = i % STAGES;
        mbar_wait(&sm.empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_tx(&sm.full[s], 2 * FWD_BK * D * 2);
        tma_tile<D>(&sm.k[s][0][0][0], FWD_BK, &tk, &sm.full[s],
                    kt * FWD_BK, g, b);
        tma_tile<D>(&sm.v[s][0][0][0], FWD_BK, &tv, &sm.full[s],
                    kt * FWD_BK, g, b);
      }
    }
  } else {
    // -- consumers: 64 query rows each ------------------------------------
    regs_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % WG, lane = tid % 32;
    const int t = lane % 4;
    const int row0 = q0 + 64 * cw + 16 * (tid / 32) + lane / 4;  // and +8
    const int wg_first = q0 + 64 * cw, wg_last = wg_first + 63;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

    mbar_wait(&sm.q_full, 0);
    for (int kt = kt0, i = 0; kt < kt1; ++kt, ++i) {
      const int s = i % STAGES;
      const int k0 = kt * FWD_BK;
      mbar_wait(&sm.full[s], (i / STAGES) & 1);

      // S = Q K^T (64 x 128), float32
      float sc[FWD_BK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_k(&sm.q[0][0][0], FWD_BQ, 64 * cw, kk),
                 desc_k(&sm.k[s][0][0][0], FWD_BK, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // does the mask or the key edge touch this tile for these rows?
      const bool edge =
          k0 + FWD_BK > a.Sk
          || (a.causal && k0 + FWD_BK - 1 > q_off + wg_first)
          || (a.window > 0 && q_off + wg_last - k0 >= a.window);
      float corr[2];
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int qp = q_off + row0 + 8 * ri;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < FWD_BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * j + 2 * ri + c];
            x = __fmul_rn(x, a.scale);
            if (edge) {
              const int kp = k0 + 8 * j + 2 * t + c;
              if (kp >= a.Sk)
                x = -INFINITY;  // no key: probability exactly 0
              else if (!keep(qp, kp, a.causal, a.window))
                x = NEG_INF;
            }
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[ri], mx);
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < FWD_BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * j + 2 * ri + c];
            x = expf(x - m_new);
            sum += x;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        corr[ri] = expf(m[ri] - m_new);
        l[ri] = l[ri] * corr[ri] + sum;
        m[ri] = m_new;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }

      // P in two bf16 pieces, as A fragments: k-step i is sc[8 i .. 8 i + 7]
      uint32_t p_hi[FWD_BK / 4], p_lo[FWD_BK / 4];
#pragma unroll
      for (int e = 0; e < FWD_BK / 4; ++e)
        split2(sc[2 * e], sc[2 * e + 1], p_hi[e], p_lo[e]);

      // O += P_hi V + P_lo V
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < FWD_BK / 16; ++kk)
        wgmma_rs(acc, &p_hi[4 * kk], desc_mn(&sm.v[s][0][0][0], FWD_BK, kk));
#pragma unroll
      for (int kk = 0; kk < FWD_BK / 16; ++kk)
        wgmma_rs(acc, &p_lo[4 * kk], desc_mn(&sm.v[s][0][0][0], FWD_BK, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      mbar_arrive(&sm.empty[s]);
    }

    // O and lse; rows past Sq are not stored
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int r = row0 + 8 * ri;
      if (r >= a.Sq) continue;
      const float l_safe = fmaxf(l[ri], 1e-30f);
      __nv_bfloat16* orow = a.o + b * a.so.b + (long long)r * a.so.s
                            + h * a.so.h;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 pair = __floats2bfloat162_rn(
            acc[4 * j + 2 * ri] / l_safe, acc[4 * j + 2 * ri + 1] / l_safe);
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t) = pair;
      }
      if (t == 0)
        a.lse[((long long)b * a.H + h) * a.Sq + r] = m[ri] + logf(l_safe);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const long long* st,
           int B, int G, const FwdArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, a.Sq, a.H, D, Strides{st[0], st[1], st[2]},
                     FWD_BQ);
  if (!err)
    err = make_map(&tk, k, B, a.Sk, G, D, Strides{st[3], st[4], st[5]},
                   fwd_bk<D>());
  if (!err)
    err = make_map(&tv, v, B, a.Sk, G, D, Strides{st[6], st[7], st[8]},
                   fwd_bk<D>());
  if (err) return err;
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.Sq + FWD_BQ - 1) / FWD_BQ, a.H, B);
  flash_fwd_tc_kernel<D><<<grid, THREADS, smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tc
}  // namespace flash

// Plain C entry point (loaded with ctypes).  q (B, H, Sq, D) and k/v
// (B, H / rep, Sk, D) bfloat16, D 64, 128 or 256, read through the strides
// st = [q b, s, h, k b, s, h, v b, s, h, o b, s, h] (elements, head
// dimension contiguous; the b, s and h strides multiples of 8 and the
// pointers 16-byte aligned, as TMA needs); q_off one device int32; o
// (B, H, Sq, D) bfloat16 through its strides, lse (B, H, Sq) float32
// contiguous.  Launches on `stream` and returns 0, a CUDA error code, or
// 100000 + a CUresult when a tensor map cannot be built.
extern "C" int flash_fwd_tc_launch(const void* q, const void* k,
                                   const void* v, const void* q_off, void* o,
                                   void* lse, const long long* st, int B,
                                   int H, int rep, int Sq, int Sk, int D,
                                   int causal, int window, float scale,
                                   void* stream) {
  flash::tc::FwdArgs a;
  a.o = (__nv_bfloat16*)o;
  a.lse = (float*)lse;
  a.q_off = (const int*)q_off;
  a.so = flash::Strides{st[9], st[10], st[11]};
  a.H = H;
  a.rep = rep;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.window = window;
  a.scale = scale;
  auto s = (cudaStream_t)stream;
  if (D == 64) return flash::tc::launch<64>(q, k, v, st, B, H / rep, a, s);
  if (D == 128) return flash::tc::launch<128>(q, k, v, st, B, H / rep, a, s);
  if (D == 256) return flash::tc::launch<256>(q, k, v, st, B, H / rep, a, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_fwd_tc_error_string(int err) {
  return flash::tc::error_string(err);
}

// Dynamic shared memory a block takes at head dim D (0 for another D).
extern "C" int flash_fwd_tc_smem_bytes(int D) {
  if (D == 64) return (int)flash::tc::fwd_smem_bytes<64>();
  if (D == 128) return (int)flash::tc::fwd_smem_bytes<128>();
  if (D == 256) return (int)flash::tc::fwd_smem_bytes<256>();
  return 0;
}

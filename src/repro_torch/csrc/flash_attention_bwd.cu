// Flash-attention backward for Hopper (sm_90a): the training gradients, on
// bf16 tensor cores.
//
// Replaces: src/repro/kernels/flash_attention.py:321,
// flash_attention_bwd_pallas (bodies _dq_kernel :256 and _dkv_kernel :284,
// helpers _recompute_p and _softcap_jac).
//
// Given q, k, v, the upstream gradient do, the forward's row log-sum-exp
// and dmat = rowsum(do * o) (f32, computed by the wrapper), both kernels
// recompute p = exp(s - lse) tile by tile and form
//   s  = (q . k) * scale               (bf16 operands, f32 sums)
//   s  = tanh(s / c) * c, jac = 1 - t^2 (softcap c, else jac = 1)
//   s  = -1e30 where masked            (finite: masked p is exactly 0)
//   dp = do . v                        (do in bf16, f32 sums)
//   ds = p * (dp - dmat) * jac * scale
//   dq = bf16(ds) . k                  (bwd_dq_kernel)
//   dk = bf16(ds)^T . q                (bwd_dkv_kernel)
//   dv = p^T . do, p kept in f32       (bwd_dkv_kernel)
// with the reference's casts: ds is rounded to bf16 before the dq and dk
// products, p is not rounded before the dv product.  Every product runs on
// mma.sync.m16n8k16 bf16 with f32 accumulators; the operands are the
// reference's own bf16 values, so only the order of the f32 sums differs.
// The f32 p of the dv product is split as p = p_hi + p_lo, p_hi = bf16(p),
// p_lo = bf16(p - p_hi), and both halves are multiplied by do (exact in
// bf16) into the same f32 accumulator: |p - p_hi - p_lo| <= 2^-16 |p|.
//
// What bounds it on an H100: at the training shape (qwen3-4b, batch 8,
// seq 256: BH 256, group 4, S 256, d 128, causal) the function moves
// 92.8 MB (q, k, v, do in bf16, lse and dmat, dq/dk/dv in f32: 0.0277 ms
// at 3.35 TB/s) and does 10.8 GFLOP of useful bf16 work (10 d per unmasked
// pair: 0.011 ms at 989 TFLOP/s), so the bound is the bytes.  The kernels
// do more MMA work than that: the split dv doubles the dv product, both
// kernels recompute s and dp (8 products of 2 d per pair where the
// function needs 5), and diagonal tiles are computed in full and masked;
// ~21 GFLOP in all at this shape, ~0.02 ms at the bf16 peak, more at
// mma.sync's rate.
//
// Design: two kernels, no atomics, deterministic.
// - bwd_dq_kernel: a block owns 64 query rows of one head (4 warps of 16
//   rows) with q and do resident in shared memory, and walks the 32-key
//   K/V tiles through a 2-stage cp.async ring.  Per tile a warp forms
//   S = Q K^T and dP = dO V^T (16 x 32 in registers), turns them into
//   bf16(ds) in the accumulator layout, which is the A operand layout of
//   the next MMA, and adds dS K into its dq rows.  32-key tiles keep the
//   block at 70 KB of shared memory and 164 registers a thread, so an SM
//   holds 3 blocks; 64-key tiles (104 KB, 174 registers) allow 2.
// - bwd_dkv_kernel: a block owns 64 key rows of one KV head (4 warps of 16
//   rows) with k and v resident, and walks every query head of the group
//   and its 32-query tiles of q, do, lse and dmat through the same ring;
//   a warp forms S^T = K Q^T and dP^T = V dO^T, so that p^T and ds^T land
//   in the A layout, and adds p^T dO (split) and dS^T Q into dv and dk,
//   summed over the group in registers.
// - Operands come from shared memory by ldmatrix (.trans for dO, Q and K
//   where they are the B operand of a product over the walked rows); rows
//   are padded by 16 bytes, so the eight rows of each 8x8 matrix fall in
//   distinct banks.
// - Tiles wholly outside the causal limit or the window are skipped; only
//   tiles that cross the diagonal, the window's edge or a ragged end
//   evaluate the mask.  Heavy tiles launch first: the dq grid walks query
//   tiles from the last, the dk/dv grid key tiles from the first.
// - Instances by head width D = 64, 128, 256 (the wrapper zero-pads d and
//   dv to D).  At D = 256 the 16 x 256 dq, dk and dv accumulators of a
//   warp would not fit in registers, so each row slab has two warps, one
//   per half of the output columns, each recomputing S and dP over the
//   full width.
// - What holds it back now, most likely (not confirmed by hardware
//   counters): the dk/dv kernel's 16 x 128 dk and dv
//   accumulators take ~240 registers a thread, so an SM holds 8 of its
//   warps, few to hide mma.sync and ldmatrix latency; wgmma (64-row
//   warpgroup tiles, B from shared memory) is the next lever.
// - The tile helpers (cp.async, ldmatrix, mma.sync, the mask) live in
//   mma_common.cuh, shared with the forward (flash_attention.cu).

#include "mma_common.cuh"

namespace {

using namespace tc;

// Per-instance tile sizes (the width D is picked by bwd_width in
// kernels/flash_attention.py).  A block owns Q_ROWS query rows (dq kernel)
// or K_ROWS key rows (dk/dv kernel), in slabs of 16 rows, one warp per
// slab and output column half.
template <int D>
struct Cfg {
  static constexpr int NSPLIT = D > 128 ? 2 : 1;  // output column halves
  static constexpr int DO = D / NSPLIT;           // output columns a warp owns
  static constexpr int LD = D + 8;                // padded smem row (bf16)
  static constexpr int Q_ROWS = 64;               // query rows per dq block
  static constexpr int K_ROWS = 64;               // key rows per dk/dv block
  static constexpr int KT = 32;                   // keys per dq-kernel tile
  static constexpr int QT = 32;                   // queries per dk/dv tile
  static constexpr int DQ_THREADS = 2 * Q_ROWS * NSPLIT;   // 32 per slab
  static constexpr int DKV_THREADS = 2 * K_ROWS * NSPLIT;
  static constexpr int DQ_SMEM = (2 * Q_ROWS + 4 * KT) * LD * 2;
  static constexpr int DKV_SMEM =
      (2 * K_ROWS + 4 * QT) * LD * 2 + 4 * QT * 4;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The same for two A operands against one B (the hi and lo halves of p):
// acc += a0 . B + a1 . B, each B fragment loaded once.
template <int LD, int DO>
__device__ __forceinline__ void mma_ab2(float (&acc)[DO / 8][4],
                                        const uint32_t (&a0)[4],
                                        const uint32_t (&a1)[4],
                                        const __nv_bfloat16* b_base,
                                        int col0, int lane) {
  const uint32_t b_addr =
      smem_u32(b_base + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + col0 +
               (lane >> 4) * 8);
#pragma unroll
  for (int nd = 0; nd < DO / 16; ++nd) {
    uint32_t b[4];
    ldsm4t(b, b_addr + nd * 32);
    mma(acc[2 * nd], a0, b[0], b[1]);
    mma(acc[2 * nd + 1], a0, b[2], b[3]);
    mma(acc[2 * nd], a1, b[0], b[1]);
    mma(acc[2 * nd + 1], a1, b[2], b[3]);
  }
}

// One score element: p and ds from the raw dot products, the reference's
// order of operations.
__device__ __forceinline__ void pair_grad(float qk, float dp, float lse,
                                          float dmat, float scale,
                                          float softcap, bool valid,
                                          float& p, float& ds) {
  float s = qk * scale;
  float jac = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    s = t * softcap;
    jac = 1.f - t * t;
  }
  if (!valid) s = NEG_INF;
  p = expf(s - lse);
  ds = p * (dp - dmat) * jac * scale;
}

// ---------------------------------------------------------------------------
// dq: a block owns ROWS query rows of one head and walks the K/V tiles.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Cfg<D>::DQ_THREADS)
bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const __nv_bfloat16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dmat,
              float* __restrict__ dq, int Sq, int Sk, int group, float scale,
              float softcap, int causal, int window) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, KT = C::KT, DO = C::DO, ROWS = C::Q_ROWS;
  constexpr int NT = C::DQ_THREADS, SLABS = ROWS / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sDO = sQ + ROWS * LD;
  __nv_bfloat16* sK = sDO + ROWS * LD;     // [2][KT][LD]
  __nv_bfloat16* sV = sK + 2 * KT * LD;    // [2][KT][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp % SLABS, wc = warp / SLABS;  // row slab, column half
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // last tile first
  const __nv_bfloat16* qb = q + ((size_t)bh * Sq + q0) * D;
  const __nv_bfloat16* dob = dout + ((size_t)bh * Sq + q0) * D;
  const __nv_bfloat16* kb = k + (size_t)(bh / group) * Sk * D;
  const __nv_bfloat16* vb = v + (size_t)(bh / group) * Sk * D;

  const int q_last = min(q0 + ROWS, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  // a row with no key in its window (q >= Sk + window - 1) has lse -1e30
  // and p = 1 on every key, as in the reference: its block walks every
  // tile (kv_end is Sk then; the tiles before the window are edge tiles)
  if (window > 0 && q_last >= Sk + window - 1) kv_begin = 0;
  kv_begin = (kv_begin / KT) * KT;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + KT - 1) / KT
                                        : 0;

  load_rows<D, NT>(sQ, qb, ROWS, Sq - q0, tid);
  load_rows<D, NT>(sDO, dob, ROWS, Sq - q0, tid);
  auto load_kv = [&](int stage, int kt) {
    load_rows<D, NT>(sK + stage * KT * LD, kb + (size_t)kt * D, KT, Sk - kt,
                     tid);
    load_rows<D, NT>(sV + stage * KT * LD, vb + (size_t)kt * D, KT, Sk - kt,
                     tid);
  };
  if (n_tiles > 0) load_kv(0, kv_begin);
  cp_commit();

  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wr * 16 + g;          // this thread's rows r0, r0 + 8
  float row_lse[2], row_dm[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    row_lse[h] = r < Sq ? lse[(size_t)bh * Sq + r] : 0.f;
    row_dm[h] = r < Sq ? dmat[(size_t)bh * Sq + r] : 0.f;
  }
  float acc[DO / 8][4];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int kt = kv_begin + j * KT;
    if (j + 1 < n_tiles) load_kv((j + 1) & 1, kt + KT);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const __nv_bfloat16* cK = sK + (j & 1) * KT * LD;
    const __nv_bfloat16* cV = sV + (j & 1) * KT * LD;

    float s[KT / 8][4], dp[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, KT>(s, sQ + wr * 16 * LD, cK, lane);
    mma_abt<D, KT>(dp, sDO + wr * 16 * LD, cV, lane);

    const bool edge = (causal && kt + KT - 1 > q0) ||
                      (window > 0 && q_last - kt >= window) ||
                      kt + KT > Sk || q0 + ROWS > Sq;
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const bool valid =
            !edge || pair_valid(r0 + 8 * h, kt + n * 8 + 2 * t + (e & 1), Sq,
                                Sk, causal, window);
        float p, ds;
        pair_grad(s[n][e], dp[n][e], row_lse[h], row_dm[h], scale, softcap,
                  valid, p, ds);
        s[n][e] = ds;                 // packed to bf16 below: bf16(ds)
      }
#pragma unroll
    for (int kb2 = 0; kb2 < KT / 16; ++kb2) {
      uint32_t a[4];
      a_from_acc(a, s, kb2);
      mma_ab<LD, DO>(acc, a, cK + kb2 * 16 * LD, wc * DO, lane);
    }
    __syncthreads();                  // stage (j & 1) is reloaded at j + 2
  }
  cp_wait<0>();

  float* out = dq + (size_t)bh * Sq * D + wc * DO + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= Sq) continue;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n)
      *reinterpret_cast<float2*>(out + (size_t)r * D + n * 8) =
          make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// dk/dv: a block owns ROWS key rows of one KV head and walks the group's
// query heads and their query tiles; dk and dv sum in registers.
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(Cfg<D>::DKV_THREADS)
bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dmat,
               float* __restrict__ dk, float* __restrict__ dvo, int Sq,
               int Sk, int group, float scale, float softcap, int causal,
               int window) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, QT = C::QT, DO = C::DO, ROWS = C::K_ROWS;
  constexpr int NT = C::DKV_THREADS, SLABS = ROWS / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + ROWS * LD;
  __nv_bfloat16* sQ = sV + ROWS * LD;      // [2][QT][LD]
  __nv_bfloat16* sDO = sQ + 2 * QT * LD;   // [2][QT][LD]
  float* sL = reinterpret_cast<float*>(sDO + 2 * QT * LD);  // [2][QT]
  float* sD = sL + 2 * QT;                                   // [2][QT]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp % SLABS, wc = warp / SLABS;
  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * ROWS;        // first key tile first
  const int k_last = min(k0 + ROWS, Sk) - 1;
  const int q_begin = causal ? (k0 / QT) * QT : 0;
  // rows q >= Sk + window - 1 see no key in their window and take p = 1
  // on every key (the reference's lse -1e30): every key block walks them
  const bool no_key_rows = window > 0 && Sq > Sk + window - 1;
  const int q_end =
      window > 0 && !no_key_rows ? min(Sq, k_last + window) : Sq;
  const int n_q = q_end > q_begin ? (q_end - q_begin + QT - 1) / QT : 0;
  const int n_iter = group * n_q;

  load_rows<D, NT>(sK, k + ((size_t)bkv * Sk + k0) * D, ROWS, Sk - k0, tid);
  load_rows<D, NT>(sV, v + ((size_t)bkv * Sk + k0) * D, ROWS, Sk - k0, tid);
  auto load_q = [&](int stage, int it) {
    const int bh = bkv * group + it / n_q;
    const int qt = q_begin + (it % n_q) * QT;
    const size_t row0 = (size_t)bh * Sq + qt;
    load_rows<D, NT>(sQ + stage * QT * LD, q + row0 * D, QT, Sq - qt, tid);
    load_rows<D, NT>(sDO + stage * QT * LD, dout + row0 * D, QT, Sq - qt,
                     tid);
    if (tid < QT) {
      const bool in = qt + tid < Sq;
      cp4(sL + stage * QT + tid, in ? lse + row0 + tid : lse, in);
      cp4(sD + stage * QT + tid, in ? dmat + row0 + tid : dmat, in);
    }
  };
  if (n_iter > 0) load_q(0, 0);
  cp_commit();

  const int g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + wr * 16 + g;         // this thread's keys kr0, kr0 + 8
  float acc_k[DO / 8][4], acc_v[DO / 8][4];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int qt = q_begin + (it % n_q) * QT;
    if (it + 1 < n_iter) load_q((it + 1) & 1, it + 1);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const __nv_bfloat16* cQ = sQ + (it & 1) * QT * LD;
    const __nv_bfloat16* cDO = sDO + (it & 1) * QT * LD;
    const float* cL = sL + (it & 1) * QT;
    const float* cD = sD + (it & 1) * QT;

    float s[QT / 8][4], dp[QT / 8][4];   // S^T and dP^T: 16 keys x QT
#pragma unroll
    for (int n = 0; n < QT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_abt<D, QT>(s, sK + wr * 16 * LD, cQ, lane);
    mma_abt<D, QT>(dp, sV + wr * 16 * LD, cDO, lane);

    const bool edge = (causal && qt < k0 + ROWS - 1) ||
                      (window > 0 && qt + QT - 1 - k0 >= window) ||
                      qt + QT > Sq || k0 + ROWS > Sk;
#pragma unroll
    for (int n = 0; n < QT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);   // query column in the tile
        const bool valid =
            !edge || pair_valid(qt + c, kr0 + 8 * (e >> 1), Sq, Sk, causal,
                                window);
        float p, ds;
        pair_grad(s[n][e], dp[n][e], cL[c], cD[c], scale, softcap, valid, p,
                  ds);
        s[n][e] = p;                  // p^T, f32
        dp[n][e] = ds;                // ds^T, packed to bf16 below
      }
#pragma unroll
    for (int kb2 = 0; kb2 < QT / 16; ++kb2) {
      // dv += p^T dO, p split into bf16 hi + lo
      uint32_t a_hi[4], a_lo[4];
      a_from_acc(a_hi, s, kb2);
      float lo[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          lo[h][e] = s[2 * kb2 + h][e] - bf16_round(s[2 * kb2 + h][e]);
      a_lo[0] = pack(lo[0][0], lo[0][1]);
      a_lo[1] = pack(lo[0][2], lo[0][3]);
      a_lo[2] = pack(lo[1][0], lo[1][1]);
      a_lo[3] = pack(lo[1][2], lo[1][3]);
      mma_ab2<LD, DO>(acc_v, a_hi, a_lo, cDO + kb2 * 16 * LD, wc * DO,
                      lane);
      // dk += bf16(ds)^T Q
      uint32_t a[4];
      a_from_acc(a, dp, kb2);
      mma_ab<LD, DO>(acc_k, a, cQ + kb2 * 16 * LD, wc * DO, lane);
    }
    __syncthreads();
  }
  cp_wait<0>();

  const size_t base = (size_t)bkv * Sk * D + wc * DO + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = kr0 + 8 * h;
    if (r >= Sk) continue;
#pragma unroll
    for (int n = 0; n < DO / 8; ++n) {
      const size_t off = base + (size_t)r * D + n * 8;
      *reinterpret_cast<float2*>(dk + off) =
          make_float2(acc_k[n][2 * h], acc_k[n][2 * h + 1]);
      *reinterpret_cast<float2*>(dvo + off) =
          make_float2(acc_v[n][2 * h], acc_v[n][2 * h + 1]);
    }
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* dmat, void* dq, int BH, int Sq,
              int Sk, int group, float scale, float softcap, int causal,
              int window, cudaStream_t stream) {
  using C = Cfg<D>;
  static const int attr = set_smem(bwd_dq_kernel<D>, C::DQ_SMEM);
  if (attr != 0) return attr;
  dim3 grid(BH, (Sq + C::Q_ROWS - 1) / C::Q_ROWS);
  bwd_dq_kernel<D><<<grid, C::DQ_THREADS, C::DQ_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dmat),
      static_cast<float*>(dq), Sq, Sk, group, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* dmat, void* dk, void* dv, int BH,
               int Sq, int Sk, int group, float scale, float softcap,
               int causal, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  static const int attr = set_smem(bwd_dkv_kernel<D>, C::DKV_SMEM);
  if (attr != 0) return attr;
  dim3 grid(BH / group, (Sk + C::K_ROWS - 1) / C::K_ROWS);
  bwd_dkv_kernel<D><<<grid, C::DKV_THREADS, C::DKV_SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dmat),
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Sk, group, scale,
      softcap, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (BH, Sq, D), k, v: (BH/group, Sk, D), dout: (BH, Sq, D), bf16,
// contiguous, with D = 64, 128 or 256 (the wrapper zero-pads d and dv to
// it); lse, dmat: (BH, Sq) f32.  dq: (BH, Sq, D) f32.  Returns
// cudaErrorInvalidValue for another D.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dmat,
                                      void* dq, int BH, int Sq, int Sk, int D,
                                      int group, float scale, float softcap,
                                      int causal, int window, void* stream) {
  auto fn = D == 64 ? launch_dq<64>
            : D == 128 ? launch_dq<128>
            : D == 256 ? launch_dq<256> : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, dout, lse, dmat, dq, BH, Sq, Sk, group, scale, softcap,
            causal, window, static_cast<cudaStream_t>(stream));
}

// Same inputs; dk, dv: (BH/group, Sk, D) f32, already summed over the
// group.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* dmat,
                                       void* dk, void* dv_out, int BH, int Sq,
                                       int Sk, int D, int group, float scale,
                                       float softcap, int causal, int window,
                                       void* stream) {
  auto fn = D == 64 ? launch_dkv<64>
            : D == 128 ? launch_dkv<128>
            : D == 256 ? launch_dkv<256> : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, dout, lse, dmat, dk, dv_out, BH, Sq, Sk, group, scale,
            softcap, causal, window, static_cast<cudaStream_t>(stream));
}

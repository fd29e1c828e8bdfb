// Flash-attention forward for Hopper (sm_90a): causal prefill and the
// training forward, on bf16 tensor cores.
//
// Replaces: src/repro/kernels/flash_attention.py:90,
// flash_attention_fwd_pallas (body _fwd_kernel :48, mask _mask :34).
//
// Computes, per query head bh (reading K/V row bh // group: GQA without a
// materialised repeat)
//   s   = (q . k) * scale                 bf16 operands, f32 sums
//   s   = tanh(s / c) * c                 if softcap c
//   s   = -1e30 where masked              causal by absolute index, window,
//                                         keys at or past Sk
//   m'  = max(m, rowmax s);  p = exp(s - m');  corr = exp(m - m')
//   l   = l * corr + rowsum(p)            the f32 p
//   acc = acc * corr + bf16(p) . v        the bf16 p
//   o   = bf16(acc / max(l, 1e-30));  lse = m + log(max(l, 1e-30))
// with the reference's casts: l sums the f32 p while the PV product takes p
// rounded to bf16, and the mask is the finite sentinel (a fully masked
// first tile gives exp(0) = 1, wiped later by corr = exp(-1e30 - m) = 0;
// -inf would give NaN there).  A row with no key in its window (q >= Sk +
// window - 1) thus averages all Sk values with lse = -1e30, as the
// reference does: its block walks every tile, and at the end its l, which
// counted the tile's padding keys past Sk too (zero values), is set to
// Sk.  The kernel keeps s, m in log2 units (s * log2 e, the sentinel too)
// so that each exp is one exp2f; otherwise only the order of the f32 sums
// differs from the reference.  f32 inputs take the SIMT route in
// attention_f32.cu.
//
// What bounds it on an H100: at the training shape (qwen3-4b, batch 8,
// seq 256: BH 256, group 4, S 256, d 128, causal) the function moves
// 42.2 MB (q, o, k, v in bf16, lse in f32: 0.0126 ms at 3.35 TB/s) and does
// 4.31 GFLOP of useful work (0.0044 ms at 989 TFLOP/s), so the bound is the
// bytes; diagonal tiles computed in full add ~25% of MMA work.  At the serve
// prefill (BH 32, group 8, S 128) it is ~4 MB and ~0.1 GFLOP: latency.
//
// Design: the backward's tile machinery (mma_common.cuh) turned around.
// - A block owns ROWS = 64 query rows of one head, one warp per 16-row
//   slab, q resident in shared memory, and walks KT-key K/V tiles through
//   a 2-stage cp.async ring; K and V of a tile are separate copy groups,
//   so S = Q K^T starts before V has landed.  16- and 32-row blocks, which
//   would fill more SMs at the serve prefill (BH 32, S 128: 64 blocks on
//   132 SMs), were slower there and at the training shape: each block
//   reloads the K/V tiles it walks.
// - Per tile a warp forms S = Q K^T (16 x KT) on mma.sync.m16n8k16 with
//   ldmatrix operands and runs the online softmax in the accumulator
//   layout: the row max by two quad shuffles; the row sum l stays per
//   thread (its own columns) and is summed over the quad once, at the end.
// - bf16(p) is the A operand of the PV product straight from registers
//   (the m16n8k16 accumulator layout is the A layout); V is the B operand
//   through ldmatrix.trans.  No score leaves registers.
// - Tiles wholly outside the causal limit or the window are skipped; only
//   tiles on the diagonal, the window's edge or the ragged end of Sk
//   evaluate the mask.  The grid runs heads fastest, so the query heads of
//   a group (adjacent bh) read the same K/V tiles from L2 at about the same
//   time, and query tiles from the last (the heaviest under the causal
//   mask) to the first.
// - Instances by head width D = 64, 128, 256 (the wrapper zero-pads d and
//   dv to D: zero columns change neither q . k nor lse and give zero
//   output columns).  At D = 256 a warp's 16 x 256 f32 output accumulator
//   would be 128 registers a thread, so each slab has two warps, one per
//   half of the output columns, each recomputing S; K/V tiles are 32 keys
//   there (64 at D <= 128), ~100 KB of shared memory at 64 rows.
// - The output leaves through shared memory (the q tile, free by then) as
//   16-byte row chunks.
// - Tried on the H100 and not kept, none faster: 32-key tiles at D = 128,
//   128-row blocks, 32 rows per warp (two m16 tiles sharing each K and V
//   fragment), q fragments held in registers, more blocks per SM, and a
//   persistent grid that loads the next tile's q during the last K/V tile.
// - What holds it back (chip_smoke.py's scaling line): at one K/V tile per
//   block it is close to SDPA's forward; the gap opens with the tiles a
//   block walks, so it is the per-tile rate of this mma.sync loop (16-row
//   warp tiles, a barrier per K and per V tile), not the loads.
// Not used: wgmma and TMA (64-row warpgroup tiles), the later lever.

#include "mma_common.cuh"

namespace {

using namespace tc;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED = NEG_INF * LOG2E;  // the sentinel in log2 units
constexpr int ROWS = 64;                   // query rows per block

template <int D>
struct Cfg {
  static constexpr int NSPLIT = D > 128 ? 2 : 1;  // output column halves
  static constexpr int DO = D / NSPLIT;           // output columns a warp owns
  static constexpr int LD = D + 8;                // padded smem row (bf16)
  static constexpr int KT = D > 128 ? 32 : 64;    // keys per K/V tile
  static constexpr int SMEM = (ROWS + 4 * KT) * LD * 2;
};

template <int D>
__global__ void __launch_bounds__(2 * ROWS * Cfg<D>::NSPLIT, 1)
flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int Sq, int Sk, int group, float scale, float softcap,
                     int causal, int window) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, KT = C::KT, DO = C::DO;
  constexpr int NT = 2 * ROWS * C::NSPLIT, SLABS = ROWS / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [ROWS][LD]
  __nv_bfloat16* sK = sQ + ROWS * LD;      // [2][KT][LD]
  __nv_bfloat16* sV = sK + 2 * KT * LD;    // [2][KT][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp % SLABS, wc = warp / SLABS;  // row slab, column half
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // last tile first
  const __nv_bfloat16* kb = k + (size_t)(bh / group) * Sk * D;
  const __nv_bfloat16* vb = v + (size_t)(bh / group) * Sk * D;

  const int q_last = min(q0 + ROWS, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  // a row with no key in its window averages every key (kv_end is Sk then)
  if (window > 0 && q_last >= Sk + window - 1) kv_begin = 0;
  kv_begin = (kv_begin / KT) * KT;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + KT - 1) / KT
                                        : 0;

  // K and V tiles are committed as separate groups, so that S = Q K^T can
  // start while V is still in flight
  load_rows<D, NT>(sQ, q + ((size_t)bh * Sq + q0) * D, ROWS, Sq - q0, tid);
  auto load_k = [&](int stage, int kt) {
    if (kt < kv_end)
      load_rows<D, NT>(sK + stage * KT * LD, kb + (size_t)kt * D, KT,
                       Sk - kt, tid);
    cp_commit();
  };
  auto load_v = [&](int stage, int kt) {
    if (kt < kv_end)
      load_rows<D, NT>(sV + stage * KT * LD, vb + (size_t)kt * D, KT,
                       Sk - kt, tid);
    cp_commit();
  };
  load_k(0, kv_begin);                      // with q: one group
  load_v(0, kv_begin);

  const int g = lane >> 2, t = lane & 3;
  const int r0 = q0 + wr * 16 + g;          // this thread's rows r0, r0 + 8
  // scores in log2 units (s * log2 e), so that exp is one exp2f
  const float sc = softcap > 0.f ? scale : scale * LOG2E;
  float m[2] = {MASKED, MASKED};            // running max (quad-uniform)
  float l[2] = {0.f, 0.f};                  // this thread's share of l
  float acc[DO / 8][4];
#pragma unroll
  for (int n = 0; n < DO / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int kt = kv_begin + j * KT;
    load_k((j + 1) & 1, kt + KT);
    load_v((j + 1) & 1, kt + KT);
    cp_wait<3>();                     // K_j has landed (V_j may not have)
    __syncthreads();
    const __nv_bfloat16* cK = sK + (j & 1) * KT * LD;
    const __nv_bfloat16* cV = sV + (j & 1) * KT * LD;

    float s[KT / 8][4];
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma_abt<D, KT>(s, sQ + wr * 16 * LD, cK, lane);

    const bool edge = (causal && kt + KT - 1 > q0) ||
                      (window > 0 && q_last - kt >= window) || kt + KT > Sk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sc;
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap * LOG2E;
        if (edge && !pair_valid(r0 + 8 * (e >> 1),
                                kt + n * 8 + 2 * t + (e & 1), Sq, Sk, causal,
                                window))
          x = MASKED;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];
    }
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += p;               // the f32 p
        s[n][e] = p;                  // packed to bf16 below: bf16(p)
      }
#pragma unroll
    for (int n = 0; n < DO / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    cp_wait<2>();                     // V_j has landed
    __syncthreads();
#pragma unroll
    for (int kb2 = 0; kb2 < KT / 16; ++kb2) {
      uint32_t a[4];
      a_from_acc(a, s, kb2);
      mma_ab<LD, DO>(acc, a, cV + kb2 * 16 * LD, wc * DO, lane);
    }
    __syncthreads();                  // stage (j & 1) is reloaded at j + 2
  }
  cp_wait<0>();
  __syncthreads();                    // every warp is done with sQ

  float l_safe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    // m == MASKED: no key in the row's window; l counted every key walked
    // (padding too), the reference averages the Sk keys: lse = -1e30 + log Sk
    const bool no_key = m[h] == MASKED;
    l_safe[h] = fmaxf(no_key ? (float)Sk : l[h], 1e-30f);
    const int r = r0 + 8 * h;
    if (wc == 0 && t == 0 && r < Sq)
      lse[(size_t)bh * Sq + r] =
          (no_key ? NEG_INF : m[h] * LN2) + logf(l_safe[h]);
  }
  // this warp's 16 x DO output tile, staged in its own part of sQ
  __nv_bfloat16* sO = sQ + wr * 16 * LD + wc * DO;
#pragma unroll
  for (int n = 0; n < DO / 8; ++n)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(sO + (g + 8 * h) * LD + n * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] / l_safe[h],
                                acc[n][2 * h + 1] / l_safe[h]);
  __syncwarp();
  constexpr int CPR = DO / 8;         // 16-byte chunks per output row
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int row = q0 + wr * 16 + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(o + ((size_t)bh * Sq + row) * D + wc * DO +
                                c) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c);
  }
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

using LaunchFn = int (*)(const void*, const void*, const void*, void*, void*,
                         int, int, int, int, float, float, int, int,
                         cudaStream_t);

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int BH, int Sq, int Sk, int group, float scale, float softcap,
           int causal, int window, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr int smem = C::SMEM;
  auto kernel = flash_fwd_mma_kernel<D>;
  static const int attr = set_smem(kernel, smem);
  if (attr != 0) return attr;
  dim3 grid(BH, (Sq + ROWS - 1) / ROWS);
  kernel<<<grid, 2 * ROWS * C::NSPLIT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Sk, group, scale, softcap, causal,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (BH, Sq, D), k, v: (BH/group, Sk, D), bf16, contiguous, with D = 64,
// 128 or 256 (the wrapper zero-pads d and dv to it).  o: (BH, Sq, D)
// bf16, lse: (BH, Sq) f32.  Returns cudaErrorInvalidValue for another D.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int BH,
                                   int Sq, int Sk, int D, int group,
                                   float scale, float softcap, int causal,
                                   int window, void* stream) {
  const LaunchFn fn = D == 64    ? launch<64>
                      : D == 128 ? launch<128>
                      : D == 256 ? launch<256> : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, k, v, o, lse, BH, Sq, Sk, group, scale, softcap, causal,
            window, static_cast<cudaStream_t>(stream));
}

// Flash-attention forward for Hopper (sm_90a): causal prefill.
//
// Replaces: src/repro/kernels/flash_attention.py,
// flash_attention_fwd_pallas (body _fwd_kernel, mask _mask).
//
// Computes o = softmax(mask(softcap(q k^T * scale))) v per query head and
// the row log-sum-exp, with GQA: query head bh reads K/V row bh // group
// (no materialised repeat).  Causal by absolute index, optional sliding
// window, optional tanh softcap; the online softmax keeps m / l / acc in
// f32 and casts p to bf16 before PV, as the reference kernel does.  Keys
// at index >= Sk are masked (the reference pads them with zeros instead;
// under the causal mask the two agree).
//
// What bounds it on an H100: at the slice's prefill (Sq = Sk = 128,
// d = 128, 32 heads) the work is ~0.1 GFLOP and ~4 MB, far under both
// roofs, so the time is launch and latency; at long prompts it becomes
// FLOP bound (2 * 2 * Sq^2/2 * d per head at 989 TFLOP/s bf16).
// Design response (first, simple version): one block per (16-query tile,
// head); 32-key K/V tiles staged once in shared memory and shared by the
// block's 4 warps; each warp owns whole query rows, lane j scores key j,
// and the PV product broadcasts p by shuffle, so no score matrix ever
// leaves registers.  Tiles past the causal limit and before the window
// are skipped.  Scalar f32 FMAs, no tensor cores yet: mma/wgmma tiles are
// later work.  Head dims up to 256: two instances of the kernel, MAXD =
// 128 and 256, picked by max(d, dv); the wrapper zero-pads d and dv to
// multiples of 8 (zero columns change neither q.k nor lse, and give zero
// output columns, which it slices off).

#include "attention_common.cuh"

namespace {

using attn::TILE;

constexpr int WARPS = 4;
constexpr int RPW = 4;              // query rows per warp
constexpr int BQ = WARPS * RPW;     // query rows per block

template <int MAXD>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 int Sq, int Sk, int d, int dv, int group, float scale,
                 float softcap, int causal, int window) {
  using Dm = attn::Dims<MAXD>;
  using QT = typename Dm::QT;
  constexpr int LDK = Dm::LDK;
  __shared__ QT sQ[BQ][MAXD];
  __shared__ __align__(16) __nv_bfloat16 sK[TILE][LDK];
  __shared__ __align__(16) __nv_bfloat16 sV[TILE][LDK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * d;
  const __nv_bfloat16* kb = k + (size_t)(bh / group) * Sk * d;
  const __nv_bfloat16* vb = v + (size_t)(bh / group) * Sk * dv;

  for (int i = tid; i < BQ * d; i += WARPS * 32) {
    const int r = i / d, c = i % d;
    const __nv_bfloat16 x = (q0 + r < Sq) ? qb[(size_t)(q0 + r) * d + c]
                                          : __float2bfloat16_rn(0.f);
    attn::put(sQ[r][c], x);
  }

  attn::RowState<Dm::DPL> st[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) attn::row_init(st[i]);

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / TILE) * TILE;

  for (int kt = kv_begin; kt < kv_end; kt += TILE) {
    __syncthreads();                 // previous tile fully consumed
    for (int r = warp; r < TILE; r += WARPS) {
      const int kp = kt + r;
      attn::load_row(sK[r], kp < Sk ? kb + (size_t)kp * d : nullptr, d, lane);
      attn::load_row(sV[r], kp < Sk ? vb + (size_t)kp * dv : nullptr, dv,
                     lane);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = warp + WARPS * i;
      const int qpos = q0 + r;
      if (qpos >= Sq) continue;      // warp-uniform
      const int kpos = kt + lane;
      bool valid = kpos < Sk;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && (qpos - kpos < window);
      attn::row_update<MAXD>(st[i], sQ[r], sK, sV, d, dv, scale, softcap,
                             valid, lane);
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qpos = q0 + warp + WARPS * i;
    if (qpos >= Sq) continue;
    const float l_safe = fmaxf(st[i].l, 1e-30f);
    __nv_bfloat16* orow = o + ((size_t)bh * Sq + qpos) * dv;
#pragma unroll
    for (int c = 0; c < Dm::DPL; ++c) {
      const int dim = lane + 32 * c;
      if (dim < dv) orow[dim] = __float2bfloat16_rn(st[i].acc[c] / l_safe);
    }
    if (lane == 0) lse[(size_t)bh * Sq + qpos] = st[i].m + logf(l_safe);
  }
}

template <int MAXD>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int BH, int Sq, int Sk, int d, int dv, int group, float scale,
           float softcap, int causal, int window, cudaStream_t stream) {
  dim3 grid((Sq + BQ - 1) / BQ, BH);
  flash_fwd_kernel<MAXD><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Sk, d, dv, group, scale, softcap, causal,
      window);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (BH, Sq, d), k: (BH/group, Sk, d), v: (BH/group, Sk, dv), bf16,
// contiguous; d, dv <= 256 and % 8 == 0 (checked by the Python wrapper).
// o: (BH, Sq, dv) bf16, lse: (BH, Sq) f32.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int BH,
                                   int Sq, int Sk, int d, int dv, int group,
                                   float scale, float softcap, int causal,
                                   int window, void* stream) {
  auto fn = (d <= 128 && dv <= 128) ? launch<128> : launch<256>;
  return fn(q, k, v, o, lse, BH, Sq, Sk, d, dv, group, scale, softcap,
            causal, window, static_cast<cudaStream_t>(stream));
}

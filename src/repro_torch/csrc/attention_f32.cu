// The f32 routes of the three attention entry points, for Hopper (sm_90a):
// flash forward, paged decode and the flash backward (dq and dk/dv) on f32
// q, k, v (and do).
//
// Replaces, for f32 inputs: src/repro/kernels/flash_attention.py,
// flash_attention_fwd_pallas (:90), paged_decode_attention_pallas (:182)
// and flash_attention_bwd_pallas (:321), which run on whatever dtype they
// are given.  The bf16 routes are flash_attention.cu, paged_decode.cu and
// flash_attention_bwd.cu.
//
// An f32 call computes the reference's f32 function: every product in
// f32, p not rounded before PV (p.astype(v.dtype) keeps it f32) and ds
// not rounded before the dq and dk products (ds.astype(k.dtype)), so bf16
// tensor-core MMAs cannot take it.  These are SIMT kernels with scalar f32
// FMAs: only the order of the f32 sums differs from the reference.  No
// model path feeds f32 to the card (the KV cache and the activations are
// bf16), so they are written to be right, not fast.
//
// Design (the scalar kernels the bf16 routes had before their tensor-core
// redesigns, on f32 rows): a block of 4 warps owns 16 rows (queries, or
// keys for dk/dv); 32-row K/V (or Q/dO) tiles sit in shared memory with
// rows padded to an odd number of words, lane j takes tile row j for the
// scores, and the coefficient of row j (p or ds) is broadcast by shuffle
// for the products, so no score matrix leaves registers.  Instances
// MAXD = 128 and 256 by max(d, dv); f32 rows of 256 need ~80-100 KB of
// shared memory, so the tiles are dynamic shared memory.  Tiles wholly
// outside the causal limit or the window are skipped.

#include "attention_common.cuh"

namespace {

using attn::NEG_INF;
using attn::TILE;

constexpr int WARPS = 4;
constexpr int RPW = 4;              // rows per warp
constexpr int BR = WARPS * RPW;     // rows (queries or keys) per block

// ---------------------------------------------------------------------------
// Forward: one block per (16-query tile, head), the online softmax of
// attention_common.cuh per query row.
// ---------------------------------------------------------------------------

template <int MAXD>
__global__ void __launch_bounds__(WARPS * 32)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int d, int dv,
                     int group, float scale, float softcap, int causal,
                     int window) {
  using Dm = attn::Dims<MAXD>;
  constexpr int LDK = Dm::LDK;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);   // [BR][MAXD]
  float* sK = sQ + BR * MAXD;                   // [TILE][LDK]
  float* sV = sK + TILE * LDK;                  // [TILE][LDK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * BR;
  const float* qb = q + (size_t)bh * Sq * d;
  const float* kb = k + (size_t)(bh / group) * Sk * d;
  const float* vb = v + (size_t)(bh / group) * Sk * dv;

  for (int i = tid; i < BR * d; i += WARPS * 32) {
    const int r = i / d, c = i % d;
    sQ[r * MAXD + c] = q0 + r < Sq ? qb[(size_t)(q0 + r) * d + c] : 0.f;
  }

  attn::RowState<Dm::DPL> st[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) attn::row_init(st[i]);

  const int q_last = min(q0 + BR, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  // a row with no key in its window averages every key, as the reference
  // does (kv_end is Sk then)
  if (window > 0 && q_last >= Sk + window - 1) kv_begin = 0;
  kv_begin = (kv_begin / TILE) * TILE;

  for (int kt = kv_begin; kt < kv_end; kt += TILE) {
    __syncthreads();                 // previous tile fully consumed
    for (int r = warp; r < TILE; r += WARPS) {
      const int kp = kt + r;
      attn::load_row(sK + r * LDK, kp < Sk ? kb + (size_t)kp * d : nullptr,
                     d, lane);
      attn::load_row(sV + r * LDK, kp < Sk ? vb + (size_t)kp * dv : nullptr,
                     dv, lane);
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
      attn::row_update<MAXD>(st[i], sQ + r * MAXD, sK, sV, d, dv, scale,
                             softcap, valid, lane);
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qpos = q0 + warp + WARPS * i;
    if (qpos >= Sq) continue;
    // m == NEG_INF: no key in the row's window, so l counted every key
    // walked, the tile's padding past Sk too (zero values); the reference
    // averages the Sk keys
    const float l_safe =
        fmaxf(st[i].m == NEG_INF ? (float)Sk : st[i].l, 1e-30f);
    float* orow = o + ((size_t)bh * Sq + qpos) * dv;
#pragma unroll
    for (int c = 0; c < Dm::DPL; ++c) {
      const int dim = lane + 32 * c;
      if (dim < dv) orow[dim] = st[i].acc[c] / l_safe;
    }
    if (lane == 0) lse[(size_t)bh * Sq + qpos] = st[i].m + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// Backward: the reference's _dq_kernel and _dkv_kernel in f32.
// ---------------------------------------------------------------------------

// f32 row (shared, broadcast) . padded f32 row (shared, lane's own).
__device__ __forceinline__ float dot_row(const float* a, const float* b,
                                         int n) {
  float s = 0.f;
  for (int i = 0; i < n; ++i) s = fmaf(a[i], b[i], s);
  return s;
}

// p and ds for one (query, key) pair from its raw dot products, the
// reference's order of operations: ds = p * (dp - dmat) * jac * scale.
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

// 16 f32 rows (d or dv wide, zero-padded to MAXD) into a shared block.
__device__ __forceinline__ void load_block(float* dst, const float* src,
                                           int rows_left, int n, int maxd,
                                           int tid) {
  for (int i = tid; i < BR * maxd; i += WARPS * 32) {
    const int r = i / maxd, c = i % maxd;
    dst[i] = (r < rows_left && c < n) ? src[(size_t)r * n + c] : 0.f;
  }
}

template <int MAXD>
constexpr int bwd_smem() {
  return (2 * BR * MAXD + 2 * TILE * attn::Dims<MAXD>::LDK +
          2 * TILE) * 4;
}

// dq: a block owns 16 query rows of one head and walks the K/V tiles.
template <int MAXD>
__global__ void __launch_bounds__(WARPS * 32)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ dmat, float* __restrict__ dq,
                  int Sq, int Sk, int d, int dv, int group, float scale,
                  float softcap, int causal, int window) {
  using Dm = attn::Dims<MAXD>;
  constexpr int LDK = Dm::LDK, DPL = Dm::DPL;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);   // [BR][MAXD]
  float* sDO = sQ + BR * MAXD;                  // [BR][MAXD]
  float* sK = sDO + BR * MAXD;                  // [TILE][LDK]
  float* sV = sK + TILE * LDK;                  // [TILE][LDK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * BR;
  const float* kb = k + (size_t)(bh / group) * Sk * d;
  const float* vb = v + (size_t)(bh / group) * Sk * dv;
  load_block(sQ, q + ((size_t)bh * Sq + q0) * d, Sq - q0, d, MAXD, tid);
  load_block(sDO, dout + ((size_t)bh * Sq + q0) * dv, Sq - q0, dv, MAXD,
             tid);

  float row_lse[RPW], row_dmat[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qpos = q0 + warp + WARPS * i;
    row_lse[i] = qpos < Sq ? lse[(size_t)bh * Sq + qpos] : 0.f;
    row_dmat[i] = qpos < Sq ? dmat[(size_t)bh * Sq + qpos] : 0.f;
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc[i][c] = 0.f;
  }

  const int q_last = min(q0 + BR, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  // a row with no key in its window has lse -1e30 and p = 1 on every key,
  // as in the reference: its block walks every tile (kv_end is Sk then)
  if (window > 0 && q_last >= Sk + window - 1) kv_begin = 0;
  kv_begin = (kv_begin / TILE) * TILE;

  for (int kt = kv_begin; kt < kv_end; kt += TILE) {
    __syncthreads();                 // previous tile fully consumed
    for (int r = warp; r < TILE; r += WARPS) {
      const int kp = kt + r;
      attn::load_row(sK + r * LDK, kp < Sk ? kb + (size_t)kp * d : nullptr,
                     d, lane);
      attn::load_row(sV + r * LDK, kp < Sk ? vb + (size_t)kp * dv : nullptr,
                     dv, lane);
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
      float p, ds;
      pair_grad(dot_row(sQ + r * MAXD, sK + lane * LDK, d),
                dot_row(sDO + r * MAXD, sV + lane * LDK, dv), row_lse[i],
                row_dmat[i], scale, softcap, valid, p, ds);
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int dim = lane + 32 * c;
          if (dim < d) acc[i][c] = fmaf(dsj, sK[j * LDK + dim], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qpos = q0 + warp + WARPS * i;
    if (qpos >= Sq) continue;
    float* row = dq + ((size_t)bh * Sq + qpos) * d;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int dim = lane + 32 * c;
      if (dim < d) row[dim] = acc[i][c];
    }
  }
}

// dk/dv: a block owns 16 key rows of one KV head and walks the group's
// query heads and their 32-query tiles; dk and dv sum in registers.
template <int MAXD>
__global__ void __launch_bounds__(WARPS * 32)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dmat, float* __restrict__ dk,
                   float* __restrict__ dvo, int Sq, int Sk, int d, int dv,
                   int group, float scale, float softcap, int causal,
                   int window) {
  using Dm = attn::Dims<MAXD>;
  constexpr int LDK = Dm::LDK, DPL = Dm::DPL;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sKr = reinterpret_cast<float*>(smem);  // [BR][MAXD]
  float* sVr = sKr + BR * MAXD;                 // [BR][MAXD]
  float* sQ = sVr + BR * MAXD;                  // [TILE][LDK]
  float* sDO = sQ + TILE * LDK;                 // [TILE][LDK]
  float* sL = sDO + TILE * LDK;                 // [TILE]
  float* sD = sL + TILE;                        // [TILE]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bkv = blockIdx.y, k0 = blockIdx.x * BR;
  load_block(sKr, k + ((size_t)bkv * Sk + k0) * d, Sk - k0, d, MAXD, tid);
  load_block(sVr, v + ((size_t)bkv * Sk + k0) * dv, Sk - k0, dv, MAXD, tid);

  float acc_k[RPW][DPL], acc_v[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int k_last = min(k0 + BR, Sk) - 1;
  const int q_begin = causal ? (k0 / TILE) * TILE : 0;
  // rows q >= Sk + window - 1 see no key in their window and take p = 1
  // on every key (the reference's lse -1e30): every key block walks them
  const bool no_key_rows = window > 0 && Sq > Sk + window - 1;
  const int q_end =
      window > 0 && !no_key_rows ? min(Sq, k_last + window) : Sq;

  for (int g = 0; g < group; ++g) {
    const int bh = bkv * group + g;
    const float* qb = q + (size_t)bh * Sq * d;
    const float* dob = dout + (size_t)bh * Sq * dv;
    for (int qt = q_begin; qt < q_end; qt += TILE) {
      __syncthreads();               // previous tile fully consumed
      for (int r = warp; r < TILE; r += WARPS) {
        const int qp = qt + r;
        attn::load_row(sQ + r * LDK, qp < Sq ? qb + (size_t)qp * d : nullptr,
                       d, lane);
        attn::load_row(sDO + r * LDK,
                       qp < Sq ? dob + (size_t)qp * dv : nullptr, dv, lane);
      }
      if (tid < TILE) {
        const int qp = qt + tid;
        sL[tid] = qp < Sq ? lse[(size_t)bh * Sq + qp] : 0.f;
        sD[tid] = qp < Sq ? dmat[(size_t)bh * Sq + qp] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const int r = warp + WARPS * i;
        const int kpos = k0 + r;
        if (kpos >= Sk) continue;    // warp-uniform
        const int qpos = qt + lane;
        bool valid = qpos < Sq;
        if (causal) valid = valid && kpos <= qpos;
        if (window > 0) valid = valid && (qpos - kpos < window);
        float p, ds;
        pair_grad(dot_row(sKr + r * MAXD, sQ + lane * LDK, d),
                  dot_row(sVr + r * MAXD, sDO + lane * LDK, dv), sL[lane],
                  sD[lane], scale, softcap, valid, p, ds);
#pragma unroll 4
        for (int j = 0; j < TILE; ++j) {
          const float pj = __shfl_sync(0xffffffffu, p, j);
          const float dsj = __shfl_sync(0xffffffffu, ds, j);
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            const int dim = lane + 32 * c;
            if (dim < dv)
              acc_v[i][c] = fmaf(pj, sDO[j * LDK + dim], acc_v[i][c]);
            if (dim < d)
              acc_k[i][c] = fmaf(dsj, sQ[j * LDK + dim], acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int kpos = k0 + warp + WARPS * i;
    if (kpos >= Sk) continue;
    float* krow = dk + ((size_t)bkv * Sk + kpos) * d;
    float* vrow = dvo + ((size_t)bkv * Sk + kpos) * dv;
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int dim = lane + 32 * c;
      if (dim < d) krow[dim] = acc_k[i][c];
      if (dim < dv) vrow[dim] = acc_v[i][c];
    }
  }
}

template <int MAXD>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               float* lse, int BH, int Sq, int Sk, int d, int dv, int group,
               float scale, float softcap, int causal, int window,
               cudaStream_t stream) {
  constexpr int smem = attn::Dims<MAXD>::smem_bytes(BR);
  static const int attr = attn::set_smem(flash_fwd_f32_kernel<MAXD>, smem);
  if (attr != 0) return attr;
  dim3 grid((Sq + BR - 1) / BR, BH);
  flash_fwd_f32_kernel<MAXD><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, o, lse, Sq, Sk, d, dv, group, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

template <int MAXD>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* dmat,
              float* dq, int BH, int Sq, int Sk, int d, int dv, int group,
              float scale, float softcap, int causal, int window,
              cudaStream_t stream) {
  constexpr int smem = bwd_smem<MAXD>();
  static const int attr = attn::set_smem(bwd_dq_f32_kernel<MAXD>, smem);
  if (attr != 0) return attr;
  dim3 grid((Sq + BR - 1) / BR, BH);
  bwd_dq_f32_kernel<MAXD><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, dout, lse, dmat, dq, Sq, Sk, d, dv, group, scale, softcap,
      causal, window);
  return (int)cudaGetLastError();
}

template <int MAXD>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* dmat,
               float* dk, float* dv_out, int BH, int Sq, int Sk, int d,
               int dv, int group, float scale, float softcap, int causal,
               int window, cudaStream_t stream) {
  constexpr int smem = bwd_smem<MAXD>();
  static const int attr = attn::set_smem(bwd_dkv_f32_kernel<MAXD>, smem);
  if (attr != 0) return attr;
  dim3 grid((Sk + BR - 1) / BR, BH / group);
  bwd_dkv_f32_kernel<MAXD><<<grid, WARPS * 32, smem, stream>>>(
      q, k, v, dout, lse, dmat, dk, dv_out, Sq, Sk, d, dv, group, scale,
      softcap, causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (BH, Sq, d), k: (BH/group, Sk, d), v: (BH/group, Sk, dv), f32,
// contiguous; d, dv <= 256 and % 8 == 0 (checked by the Python wrapper).
// o: (BH, Sq, dv) f32, lse: (BH, Sq) f32.
extern "C" int flash_attention_fwd_f32(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       int BH, int Sq, int Sk, int d, int dv,
                                       int group, float scale, float softcap,
                                       int causal, int window, void* stream) {
  auto fn = (d <= 128 && dv <= 128) ? launch_fwd<128> : launch_fwd<256>;
  return fn(static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(o),
            static_cast<float*>(lse), BH, Sq, Sk, d, dv, group, scale,
            softcap, causal, window, static_cast<cudaStream_t>(stream));
}

// The layouts of paged_decode_attention (paged_decode.cu), in f32.
extern "C" int paged_decode_attention_f32(const void* q, const void* kpool,
                                          const void* vpool,
                                          const void* table,
                                          const void* q_pos, void* o, int B,
                                          int KVH, int G, int d, int dv,
                                          int page_size, int max_pages,
                                          float scale, float softcap,
                                          int window, void* stream) {
  return attn::paged_decode(q, kpool, vpool, table, q_pos, o, B, KVH, G, d,
                            dv, page_size, max_pages, scale, softcap,
                            window, stream);
}

// q: (BH, Sq, d), k: (BH/group, Sk, d), v: (BH/group, Sk, dv),
// dout: (BH, Sq, dv), f32, contiguous; lse, dmat: (BH, Sq) f32; d, dv
// <= 256 and % 8 == 0.  dq: (BH, Sq, d) f32.
extern "C" int flash_attention_bwd_dq_f32(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* dmat,
                                          void* dq, int BH, int Sq, int Sk,
                                          int d, int dv, int group,
                                          float scale, float softcap,
                                          int causal, int window,
                                          void* stream) {
  auto fn = (d <= 128 && dv <= 128) ? launch_dq<128> : launch_dq<256>;
  return fn(static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(dmat),
            static_cast<float*>(dq), BH, Sq, Sk, d, dv, group, scale,
            softcap, causal, window, static_cast<cudaStream_t>(stream));
}

// Same inputs; dk: (BH/group, Sk, d), dv: (BH/group, Sk, dv) f32, already
// summed over the group.
extern "C" int flash_attention_bwd_dkv_f32(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse, const void* dmat,
                                           void* dk, void* dv_out, int BH,
                                           int Sq, int Sk, int d, int dv,
                                           int group, float scale,
                                           float softcap, int causal,
                                           int window, void* stream) {
  auto fn = (d <= 128 && dv <= 128) ? launch_dkv<128> : launch_dkv<256>;
  return fn(static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<const float*>(dout),
            static_cast<const float*>(lse), static_cast<const float*>(dmat),
            static_cast<float*>(dk), static_cast<float*>(dv_out), BH, Sq, Sk,
            d, dv, group, scale, softcap, causal, window,
            static_cast<cudaStream_t>(stream));
}

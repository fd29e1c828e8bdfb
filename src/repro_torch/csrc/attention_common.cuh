// The f32 SIMT attention code: a key/value tile of 32 f32 rows in shared
// memory, the per-warp online-softmax update of one query row against it,
// and the paged-decode kernel built from them.  attention_f32.cu includes
// it (its forward kernel uses the same row update); the bf16 routes run on
// tensor cores (mma_common.cuh).  The head dim bound MAXD is a template
// parameter; each kernel has two instances, 128 and 256, and its C entry
// picks one by max(d, dv).
//
// Numerics follow the reference kernels in
// src/repro/kernels/flash_attention.py on f32 inputs: f32 scores and
// products, scale after the dot, optional tanh softcap, masked scores set
// to the finite sentinel -1e30 (never -inf: when a row's first tiles are
// fully masked, exp(-1e30 - -1e30) = 1 is accumulated and later wiped by
// corr = exp(-1e30 - m) = 0; -inf would give NaN there), f32 running max /
// denominator / accumulator, and p not rounded before PV (the reference's
// p.astype(v.dtype) keeps it f32).  No value is rounded: only the order of
// the f32 sums differs from the reference.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 32;          // keys per tile: one per lane

// Per-instance sizes for head dims <= MAXD (checked by the wrapper).  The
// tiles live in dynamic shared memory (smem_bytes): rows of 256 need
// ~80 KB.
template <int MAXD>
struct Dims {
  static constexpr int DPL = MAXD / 32;  // output dims per lane
  // padded row: an odd number of 32-bit words, so lane j reading row j
  // hits bank j (no conflict)
  static constexpr int LDK = MAXD + 1;
  static constexpr int smem_bytes(int q_rows) {
    return (q_rows * MAXD + 2 * TILE * LDK) * (int)sizeof(float);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copy one d-wide f32 row (d % 8 == 0, 16-byte aligned) into a padded
// shared row (4-byte aligned), or zeros when src is null.  Called by all
// lanes of a warp with lane-strided 16-byte chunks.
__device__ __forceinline__ void load_row(float* dst, const float* src, int d,
                                         int lane) {
  for (int c = lane * 4; c < d; c += 32 * 4) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (src != nullptr) v = *reinterpret_cast<const uint4*>(src + c);
    uint32_t* o = reinterpret_cast<uint32_t*>(dst + c);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
}

template <int DPL>
struct RowState {
  float m, l, acc[DPL];
};

template <int DPL>
__device__ __forceinline__ void row_init(RowState<DPL>& st) {
  st.m = NEG_INF;
  st.l = 0.f;
#pragma unroll
  for (int c = 0; c < DPL; ++c) st.acc[c] = 0.f;
}

// One query row (in shared memory, d wide) against the current tile: sK
// and sV hold TILE rows of stride LDK.  `valid` says whether this lane's
// key is unmasked for the row.
template <int MAXD>
__device__ __forceinline__ void row_update(
    RowState<Dims<MAXD>::DPL>& st, const float* q, const float* sK,
    const float* sV, int d, int dv, float scale, float softcap, bool valid,
    int lane) {
  constexpr int DPL = Dims<MAXD>::DPL, LDK = Dims<MAXD>::LDK;
  const float* krow = sK + lane * LDK;
  float s = 0.f;
  for (int i = 0; i < d / 2; ++i) {
    s = fmaf(q[2 * i], krow[2 * i], s);
    s = fmaf(q[2 * i + 1], krow[2 * i + 1], s);
  }
  s *= scale;
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  if (!valid) s = NEG_INF;

  const float m_new = fmaxf(st.m, warp_max(s));
  const float p = expf(s - m_new);
  const float corr = expf(st.m - m_new);
  st.l = st.l * corr + warp_sum(p);
#pragma unroll
  for (int c = 0; c < DPL; ++c) st.acc[c] *= corr;
#pragma unroll 4
  for (int j = 0; j < TILE; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int dim = lane + 32 * c;
      if (dim < dv) st.acc[c] = fmaf(pj, sV[j * LDK + dim], st.acc[c]);
    }
  }
  st.m = m_new;
}

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// ---------------------------------------------------------------------------
// Paged decode on f32 q and pools: one query per slot against shared K/V
// page pools, walking the page table itself.
//
// Replaces, for f32 inputs: src/repro/kernels/flash_attention.py:182,
// paged_decode_attention_pallas (body _paged_decode_kernel), where the TPU
// scalar-prefetches the table into BlockSpec index maps; here each block
// reads table[b, pos / page_size] itself.  The bf16 route is
// paged_decode.cu (split over the cache, tensor cores).
//
// Computes, for slot b and KV head h, the G grouped query heads' attention
// over cache positions <= q_pos[b] (optional sliding window and tanh
// softcap), online softmax in f32.  Rows past a slot's live length resolve
// to the trash page and are masked.  Design (simple; no model path feeds
// f32 to the card): one block per (KV head, slot, chunk of 16 query heads)
// so the heads of a group share every K/V row loaded; 32-row tiles
// gathered through the table into shared memory; the walk stops at
// q_pos[b].  In the reference kernel every later page is fully masked and
// contributes exp(-1e30 - m) = 0 to l and acc, so skipping those pages
// leaves the result unchanged.
// ---------------------------------------------------------------------------

constexpr int PAGED_WARPS = 4;
constexpr int PAGED_RPW = 4;                      // query heads per warp
constexpr int PAGED_GC = PAGED_WARPS * PAGED_RPW; // query heads per block

template <int MAXD>
__global__ void __launch_bounds__(PAGED_WARPS * 32)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ kpool,
                    const float* __restrict__ vpool,
                    const int* __restrict__ table,
                    const int* __restrict__ q_pos, float* __restrict__ o,
                    int KVH, int G, int d, int dv, int page_size,
                    int max_pages, float scale, float softcap, int window) {
  using Dm = Dims<MAXD>;
  constexpr int LDK = Dm::LDK, GC = PAGED_GC, RPW = PAGED_RPW;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem);   // [GC][MAXD]
  float* sK = sQ + GC * MAXD;                   // [TILE][LDK]
  float* sV = sK + TILE * LDK;                  // [TILE][LDK]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * GC;
  const int gn = min(GC, G - g0);   // query heads of this chunk
  const int qp = q_pos[b];
  const float* qb = q + (((size_t)b * KVH + h) * G + g0) * d;
  const int* row = table + (size_t)b * max_pages;

  for (int i = tid; i < gn * d; i += PAGED_WARPS * 32)
    sQ[(i / d) * MAXD + i % d] = qb[i];

  RowState<Dm::DPL> st[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) row_init(st[i]);

  const int n_keys = min(qp + 1, max_pages * page_size);
  int k_begin = window > 0 ? max(0, qp - window + 1) : 0;
  k_begin = (k_begin / TILE) * TILE;

  for (int kt = k_begin; kt < n_keys; kt += TILE) {
    __syncthreads();
    for (int r = warp; r < TILE; r += PAGED_WARPS) {
      const int pos = kt + r;
      const float* ksrc = nullptr;
      const float* vsrc = nullptr;
      if (pos < n_keys) {
        const size_t base =
            ((size_t)row[pos / page_size] * page_size + pos % page_size) *
                KVH + h;
        ksrc = kpool + base * d;
        vsrc = vpool + base * dv;
      }
      load_row(sK + r * LDK, ksrc, d, lane);
      load_row(sV + r * LDK, vsrc, dv, lane);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int gq = warp + PAGED_WARPS * i;
      if (gq >= gn) continue;        // warp-uniform
      const int kpos = kt + lane;
      bool valid = kpos < n_keys;    // n_keys <= q_pos + 1: causal
      if (window > 0) valid = valid && (qp - kpos < window);
      row_update<MAXD>(st[i], sQ + gq * MAXD, sK, sV, d, dv, scale, softcap,
                       valid, lane);
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int gq = warp + PAGED_WARPS * i;
    if (gq >= gn) continue;
    const float l_safe = fmaxf(st[i].l, 1e-30f);
    float* orow = o + (((size_t)b * KVH + h) * G + g0 + gq) * dv;
#pragma unroll
    for (int c = 0; c < Dm::DPL; ++c) {
      const int dim = lane + 32 * c;
      if (dim < dv) orow[dim] = st[i].acc[c] / l_safe;
    }
  }
}

template <int MAXD>
int paged_launch(const float* q, const float* kpool, const float* vpool,
                 const int* table, const int* q_pos, float* o, int B,
                 int KVH, int G, int d, int dv, int page_size, int max_pages,
                 float scale, float softcap, int window,
                 cudaStream_t stream) {
  constexpr int smem = Dims<MAXD>::smem_bytes(PAGED_GC);
  static const int attr = set_smem(paged_decode_kernel<MAXD>, smem);
  if (attr != 0) return attr;
  dim3 grid(KVH, B, (G + PAGED_GC - 1) / PAGED_GC);
  paged_decode_kernel<MAXD><<<grid, PAGED_WARPS * 32, smem, stream>>>(
      q, kpool, vpool, table, q_pos, o, KVH, G, d, dv, page_size, max_pages,
      scale, softcap, window);
  return (int)cudaGetLastError();
}

// q (B, KVH, G, d); pools (P, page_size, KVH, d / dv); table (B,
// max_pages) int32; q_pos (B,) int32; o (B, KVH, G, dv); f32 but the
// indices.  All contiguous; d, dv <= 256 and % 8 == 0 (checked in Python);
// any G.
inline int paged_decode(const void* q, const void* kpool, const void* vpool,
                        const void* table, const void* q_pos, void* o, int B,
                        int KVH, int G, int d, int dv, int page_size,
                        int max_pages, float scale, float softcap,
                        int window, void* stream) {
  auto fn = (d <= 128 && dv <= 128) ? paged_launch<128> : paged_launch<256>;
  return fn(static_cast<const float*>(q), static_cast<const float*>(kpool),
            static_cast<const float*>(vpool), static_cast<const int*>(table),
            static_cast<const int*>(q_pos), static_cast<float*>(o), B, KVH,
            G, d, dv, page_size, max_pages, scale, softcap, window,
            static_cast<cudaStream_t>(stream));
}

}  // namespace attn

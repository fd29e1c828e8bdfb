// Paged decode attention for Hopper (sm_90a): one query per slot against
// shared K/V page pools, walking the page table itself.
//
// Replaces: src/repro/kernels/flash_attention.py,
// paged_decode_attention_pallas (body _paged_decode_kernel), where the
// TPU scalar-prefetches the table into BlockSpec index maps; here each
// block reads table[b, pos / page_size] itself.
//
// Computes, for slot b and KV head h, the G grouped query heads' attention
// over cache positions <= q_pos[b] (optional sliding window and tanh
// softcap), online softmax in f32 with p cast to bf16 for PV.  Rows past
// a slot's live length resolve to the trash page and are masked.
//
// What bounds it on an H100: the KV bytes, (q_pos + 1) rows x KVH x
// (d + dv) x 2 bytes per slot at 3.35 TB/s; the arithmetic is ~1 FLOP per
// byte.  Design response (first, simple version): one block per (KV head,
// slot) so the G = 8 query heads of a group share every K/V row loaded
// (the cache is read once, not G times); 32-row tiles gathered through
// the table into shared memory; the walk stops at q_pos[b].  In the
// reference kernel every later page is fully masked and contributes
// exp(-1e30 - m) = 0 to l and acc, so skipping those pages leaves the
// result unchanged.  Any group size: a third grid dimension walks chunks
// of 16 query heads (one launch per call; a group above 16 reads its K/V
// rows once per chunk).  Head dims up to 256: instances MAXD = 128 and
// 256, picked by max(d, dv), as in flash_attention.cu.  Not yet done:
// splitting long caches over several blocks (flash-decoding) to fill more
// than B x KVH SMs.

#include "attention_common.cuh"

namespace {

using attn::TILE;

constexpr int WARPS = 4;
constexpr int RPW = 4;              // query heads per warp
constexpr int GC = WARPS * RPW;     // query heads per block (grid z: chunks)

template <int MAXD>
__global__ void __launch_bounds__(WARPS * 32)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kpool,
                    const __nv_bfloat16* __restrict__ vpool,
                    const int* __restrict__ table,
                    const int* __restrict__ q_pos,
                    __nv_bfloat16* __restrict__ o, int KVH, int G, int d,
                    int dv, int page_size, int max_pages, float scale,
                    float softcap, int window) {
  using Dm = attn::Dims<MAXD>;
  constexpr int LDK = Dm::LDK;
  __shared__ typename Dm::QT sQ[GC][MAXD];
  __shared__ __align__(16) __nv_bfloat16 sK[TILE][LDK];
  __shared__ __align__(16) __nv_bfloat16 sV[TILE][LDK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.x, b = blockIdx.y, g0 = blockIdx.z * GC;
  const int gn = min(GC, G - g0);   // query heads of this chunk
  const int qp = q_pos[b];
  const __nv_bfloat16* qb = q + (((size_t)b * KVH + h) * G + g0) * d;
  const int* row = table + (size_t)b * max_pages;

  for (int i = tid; i < gn * d; i += WARPS * 32)
    attn::put(sQ[i / d][i % d], qb[i]);

  attn::RowState<Dm::DPL> st[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) attn::row_init(st[i]);

  const int n_keys = min(qp + 1, max_pages * page_size);
  int k_begin = window > 0 ? max(0, qp - window + 1) : 0;
  k_begin = (k_begin / TILE) * TILE;

  for (int kt = k_begin; kt < n_keys; kt += TILE) {
    __syncthreads();
    for (int r = warp; r < TILE; r += WARPS) {
      const int pos = kt + r;
      const __nv_bfloat16* ksrc = nullptr;
      const __nv_bfloat16* vsrc = nullptr;
      if (pos < n_keys) {
        const size_t base =
            ((size_t)row[pos / page_size] * page_size + pos % page_size) *
                KVH + h;
        ksrc = kpool + base * d;
        vsrc = vpool + base * dv;
      }
      attn::load_row(sK[r], ksrc, d, lane);
      attn::load_row(sV[r], vsrc, dv, lane);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int gq = warp + WARPS * i;
      if (gq >= gn) continue;        // warp-uniform
      const int kpos = kt + lane;
      bool valid = kpos < n_keys;    // n_keys <= q_pos + 1: causal
      if (window > 0) valid = valid && (qp - kpos < window);
      attn::row_update<MAXD>(st[i], sQ[gq], sK, sV, d, dv, scale, softcap,
                             valid, lane);
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int gq = warp + WARPS * i;
    if (gq >= gn) continue;
    const float l_safe = fmaxf(st[i].l, 1e-30f);
    __nv_bfloat16* orow = o + (((size_t)b * KVH + h) * G + g0 + gq) * dv;
#pragma unroll
    for (int c = 0; c < Dm::DPL; ++c) {
      const int dim = lane + 32 * c;
      if (dim < dv) orow[dim] = __float2bfloat16_rn(st[i].acc[c] / l_safe);
    }
  }
}

template <int MAXD>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* table, const void* q_pos, void* o, int B, int KVH,
           int G, int d, int dv, int page_size, int max_pages, float scale,
           float softcap, int window, cudaStream_t stream) {
  dim3 grid(KVH, B, (G + GC - 1) / GC);
  paged_decode_kernel<MAXD><<<grid, WARPS * 32, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kpool),
      static_cast<const __nv_bfloat16*>(vpool),
      static_cast<const int*>(table), static_cast<const int*>(q_pos),
      static_cast<__nv_bfloat16*>(o), KVH, G, d, dv, page_size, max_pages,
      scale, softcap, window);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, KVH, G, d) bf16; pools: (P, page_size, KVH, d / dv) bf16;
// table: (B, max_pages) int32; q_pos: (B,) int32; o: (B, KVH, G, dv) bf16.
// All contiguous; d, dv <= 256 and % 8 == 0 (checked in Python); any G.
extern "C" int paged_decode_attention(const void* q, const void* kpool,
                                      const void* vpool, const void* table,
                                      const void* q_pos, void* o, int B,
                                      int KVH, int G, int d, int dv,
                                      int page_size, int max_pages,
                                      float scale, float softcap, int window,
                                      void* stream) {
  auto fn = (d <= 128 && dv <= 128) ? launch<128> : launch<256>;
  return fn(q, kpool, vpool, table, q_pos, o, B, KVH, G, d, dv, page_size,
            max_pages, scale, softcap, window,
            static_cast<cudaStream_t>(stream));
}

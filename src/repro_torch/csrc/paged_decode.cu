// Paged decode attention for Hopper (sm_90a), the bf16 route: one query
// per slot against shared K/V page pools, walking the page table itself.
//
// Replaces: src/repro/kernels/flash_attention.py:182,
// paged_decode_attention_pallas (body _paged_decode_kernel).
//
// The kernel, its design and what bounds it are in attention_common.cuh
// (paged_decode_kernel), templated on the element type; attention_f32.cu
// holds the f32 route.  Instances MAXD = 128 and 256, picked by
// max(d, dv).

#include "attention_common.cuh"

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
  return attn::paged_decode<__nv_bfloat16>(q, kpool, vpool, table, q_pos, o,
                                           B, KVH, G, d, dv, page_size,
                                           max_pages, scale, softcap, window,
                                           stream);
}

// Shared pieces of the two attention kernels (flash_attention.cu,
// paged_decode.cu): a key/value tile of 32 rows in shared memory and the
// per-warp online-softmax update of one query row against it.  The head
// dim bound MAXD is a template parameter; each kernel has two instances,
// 128 and 256, and its C entry picks one by max(d, dv).
//
// Numerics follow the reference kernels in
// src/repro/kernels/flash_attention.py: f32 scores (bf16 inputs, f32
// products), scale after the dot, optional tanh softcap, masked scores
// set to the finite sentinel -1e30 (never -inf: when a row's first tiles
// are fully masked, exp(-1e30 - -1e30) = 1 is accumulated and later wiped
// by corr = exp(-1e30 - m) = 0; -inf would give NaN there), f32 running
// max / denominator / accumulator, and p cast to bf16 before the PV
// product while the denominator sums the f32 p.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr float NEG_INF = -1e30f;
constexpr int TILE = 32;          // keys per tile: one per lane

// Per-instance sizes for head dims <= MAXD (checked by the wrapper).  At
// 128 the query rows stay f32 in shared memory; at 256 they are held in
// bf16 (q is bf16 already, so the products are the same) so that sQ, sK
// and sV fit the 48 KB of static shared memory (8 + 2 x 16.1 KB).
template <int MAXD>
struct Dims {
  static constexpr int DPL = MAXD / 32;  // output dims per lane
  static constexpr int LDK = MAXD + 2;   // padded bf16 row: an odd number
                                         // of words, so lane j reading row
                                         // j hits bank j (no conflict)
  using QT = typename std::conditional<(MAXD <= 128), float,
                                       __nv_bfloat16>::type;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// Store a bf16 query element into a shared row of either type.
__device__ __forceinline__ void put(float& dst, __nv_bfloat16 x) {
  dst = __bfloat162float(x);
}
__device__ __forceinline__ void put(__nv_bfloat16& dst, __nv_bfloat16 x) {
  dst = x;
}

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

// Copy one d-wide bf16 row (d % 8 == 0, 16-byte aligned) into a padded
// shared row, or zeros when src is null.  Called by all lanes of a warp
// with lane-strided 8-element chunks.
__device__ __forceinline__ void load_row(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src, int d,
                                         int lane) {
  for (int c = lane * 8; c < d; c += 32 * 8) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (src != nullptr) v = *reinterpret_cast<const uint4*>(src + c);
    uint32_t* o = reinterpret_cast<uint32_t*>(dst + c);  // 4-byte aligned
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

// One query row (in shared memory, d wide) against the current tile.
// `valid` says whether this lane's key is unmasked for the row.
template <int MAXD, typename QT = typename Dims<MAXD>::QT>
__device__ __forceinline__ void row_update(
    RowState<Dims<MAXD>::DPL>& st, const QT* q,
    const __nv_bfloat16 (*sK)[Dims<MAXD>::LDK],
    const __nv_bfloat16 (*sV)[Dims<MAXD>::LDK], int d, int dv, float scale,
    float softcap, bool valid, int lane) {
  constexpr int DPL = Dims<MAXD>::DPL;
  const __nv_bfloat162* krow =
      reinterpret_cast<const __nv_bfloat162*>(sK[lane]);
  float s = 0.f;
  for (int i = 0; i < d / 2; ++i) {
    const float2 kf = __bfloat1622float2(krow[i]);
    s = fmaf(to_f32(q[2 * i]), kf.x, s);
    s = fmaf(to_f32(q[2 * i + 1]), kf.y, s);
  }
  s *= scale;
  if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
  if (!valid) s = NEG_INF;

  const float m_new = fmaxf(st.m, warp_max(s));
  const float p = expf(s - m_new);
  const float corr = expf(st.m - m_new);
  st.l = st.l * corr + warp_sum(p);
  const float pb = __bfloat162float(__float2bfloat16_rn(p));
#pragma unroll
  for (int c = 0; c < DPL; ++c) st.acc[c] *= corr;
#pragma unroll 4
  for (int j = 0; j < TILE; ++j) {
    const float pj = __shfl_sync(0xffffffffu, pb, j);
#pragma unroll
    for (int c = 0; c < DPL; ++c) {
      const int dim = lane + 32 * c;
      if (dim < dv) st.acc[c] = fmaf(pj, __bfloat162float(sV[j][dim]),
                                     st.acc[c]);
    }
  }
  st.m = m_new;
}

}  // namespace attn

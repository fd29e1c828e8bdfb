// Flash-attention backward for Hopper (sm_90a): the training gradients.
//
// Replaces: src/repro/kernels/flash_attention.py,
// flash_attention_bwd_pallas (bodies _dq_kernel and _dkv_kernel, helpers
// _recompute_p and _softcap_jac).
//
// Given q, k, v, the upstream gradient do, the forward's row log-sum-exp
// and dmat = rowsum(do * o) (f32, computed by the wrapper), both kernels
// recompute p = exp(s - lse) tile by tile (s the masked, softcapped,
// scaled score) and form
//   dp = do . v^T                     (do in bf16, f32 products)
//   ds = p * (dp - dmat) * sech^2(s_raw / c) * scale
//   dq = bf16(ds) . k                 (flash_bwd_dq_kernel)
//   dv = p^T . do                     (p kept f32, do f32)
//   dk = bf16(ds)^T . q               (flash_bwd_dkv_kernel)
// with the reference's casts: ds is rounded to bf16 before the dq and dk
// products, p is not rounded before the dv product.  The masked score is
// the finite sentinel -1e30, so masked p is exactly 0.  Ragged Sq / Sk are
// masked here (the reference pads to the 128 grid; padded rows carry
// do = 0 and add nothing, so the two agree).
//
// What bounds it on an H100: at the training shape (qwen3-4b, batch 8,
// seq 256: BH 256, group 4, S 256, d 128) the function moves ~90 MB
// (q, k, v, do in bf16, dq/dk/dv in f32: ~27 us at 3.35 TB/s) and does
// 10 * d flops per unmasked (query, key) pair, ~10.8 GFLOP (~11 us at the
// bf16 tensor-core peak), so the bound is the bytes.  This first version
// runs scalar f32 FMAs, so it is bound by FMA throughput, far above
// either roof.
// Design response (first, simple version, the forward's layout): the dq
// kernel gives each block 16 query rows of one head and loops over 32-key
// K/V tiles up to the causal limit; the dk/dv kernel gives each block 16
// key rows of one KV head and loops over the G query heads of its group
// and their 32-query tiles from the causal start, so the group sum happens
// in registers and no per-query-head (BH, Sk, d) f32 buffer exists.  Each
// warp owns whole rows, lane j takes tile row j for the scores, and the
// coefficient (ds or p) of row j is broadcast by shuffle for the products,
// so no score matrix leaves registers.  Tensor-core tiles are later work.

#include "attention_common.cuh"

namespace {

using attn::DPL;
using attn::LDK;
using attn::MAXD;
using attn::NEG_INF;
using attn::TILE;

constexpr int WARPS = 4;
constexpr int RPW = 4;              // rows per warp
constexpr int BR = WARPS * RPW;     // rows (queries or keys) per block

// bf16 row (padded, in shared memory) . f32 row (shared, broadcast).
__device__ __forceinline__ float dot_row(const float* a,
                                         const __nv_bfloat16* b, int n) {
  const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(b);
  float s = 0.f;
  for (int i = 0; i < n / 2; ++i) {
    const float2 f = __bfloat1622float2(b2[i]);
    s = fmaf(a[2 * i], f.x, s);
    s = fmaf(a[2 * i + 1], f.y, s);
  }
  return s;
}

// ds for one (query, key) pair from its raw dot products, the reference's
// order of operations: p * (dp - dmat) * jac * scale.
struct Pair {
  float p, ds;
};

__device__ __forceinline__ Pair pair_grad(float qk, float dp, float lse,
                                          float dmat, float scale,
                                          float softcap, bool valid) {
  float s = qk * scale;
  float jac = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    s = t * softcap;
    jac = 1.f - t * t;
  }
  if (!valid) s = NEG_INF;
  Pair r;
  r.p = expf(s - lse);
  r.ds = r.p * (dp - dmat) * jac * scale;
  return r;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dmat, float* __restrict__ dq,
                    int Sq, int Sk, int d, int dv, int group, float scale,
                    float softcap, int causal, int window) {
  __shared__ float sQ[BR][MAXD];
  __shared__ float sDO[BR][MAXD];
  __shared__ __align__(16) __nv_bfloat16 sK[TILE][LDK];
  __shared__ __align__(16) __nv_bfloat16 sV[TILE][LDK];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * BR;
  const __nv_bfloat16* qb = q + (size_t)bh * Sq * d;
  const __nv_bfloat16* dob = dout + (size_t)bh * Sq * dv;
  const __nv_bfloat16* kb = k + (size_t)(bh / group) * Sk * d;
  const __nv_bfloat16* vb = v + (size_t)(bh / group) * Sk * dv;

  for (int i = tid; i < BR * MAXD; i += WARPS * 32) {
    const int r = i / MAXD, c = i % MAXD;
    const bool in = q0 + r < Sq;
    sQ[r][c] = (in && c < d) ? __bfloat162float(qb[(size_t)(q0 + r) * d + c])
                             : 0.f;
    sDO[r][c] = (in && c < dv)
                    ? __bfloat162float(dob[(size_t)(q0 + r) * dv + c])
                    : 0.f;
  }
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
      const Pair g = pair_grad(dot_row(sQ[r], sK[lane], d),
                               dot_row(sDO[r], sV[lane], dv), row_lse[i],
                               row_dmat[i], scale, softcap, valid);
      const float dsb = round_bf16(g.ds);
#pragma unroll 4
      for (int j = 0; j < TILE; ++j) {
        const float dsj = __shfl_sync(0xffffffffu, dsb, j);
#pragma unroll
        for (int c = 0; c < DPL; ++c) {
          const int dim = lane + 32 * c;
          if (dim < d)
            acc[i][c] = fmaf(dsj, __bfloat162float(sK[j][dim]), acc[i][c]);
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

__global__ void __launch_bounds__(WARPS * 32)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dmat, float* __restrict__ dk,
                     float* __restrict__ dvo, int Sq, int Sk, int d, int dv,
                     int group, float scale, float softcap, int causal,
                     int window) {
  __shared__ float sKr[BR][MAXD];
  __shared__ float sVr[BR][MAXD];
  __shared__ __align__(16) __nv_bfloat16 sQ[TILE][LDK];
  __shared__ __align__(16) __nv_bfloat16 sDO[TILE][LDK];
  __shared__ float sL[TILE], sD[TILE];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bkv = blockIdx.y, k0 = blockIdx.x * BR;
  const __nv_bfloat16* kb = k + (size_t)bkv * Sk * d;
  const __nv_bfloat16* vb = v + (size_t)bkv * Sk * dv;

  for (int i = tid; i < BR * MAXD; i += WARPS * 32) {
    const int r = i / MAXD, c = i % MAXD;
    const bool in = k0 + r < Sk;
    sKr[r][c] = (in && c < d) ? __bfloat162float(kb[(size_t)(k0 + r) * d + c])
                              : 0.f;
    sVr[r][c] = (in && c < dv)
                    ? __bfloat162float(vb[(size_t)(k0 + r) * dv + c])
                    : 0.f;
  }
  float acc_k[RPW][DPL], acc_v[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < DPL; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int k_last = min(k0 + BR, Sk) - 1;
  const int q_begin = causal ? (k0 / TILE) * TILE : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;

  for (int g = 0; g < group; ++g) {
    const int bh = bkv * group + g;
    const __nv_bfloat16* qb = q + (size_t)bh * Sq * d;
    const __nv_bfloat16* dob = dout + (size_t)bh * Sq * dv;
    for (int qt = q_begin; qt < q_end; qt += TILE) {
      __syncthreads();               // previous tile fully consumed
      for (int r = warp; r < TILE; r += WARPS) {
        const int qp = qt + r;
        attn::load_row(sQ[r], qp < Sq ? qb + (size_t)qp * d : nullptr, d,
                       lane);
        attn::load_row(sDO[r], qp < Sq ? dob + (size_t)qp * dv : nullptr, dv,
                       lane);
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
        const Pair pg = pair_grad(dot_row(sKr[r], sQ[lane], d),
                                  dot_row(sVr[r], sDO[lane], dv), sL[lane],
                                  sD[lane], scale, softcap, valid);
        const float dsb = round_bf16(pg.ds);
#pragma unroll 4
        for (int j = 0; j < TILE; ++j) {
          const float pj = __shfl_sync(0xffffffffu, pg.p, j);
          const float dsj = __shfl_sync(0xffffffffu, dsb, j);
#pragma unroll
          for (int c = 0; c < DPL; ++c) {
            const int dim = lane + 32 * c;
            if (dim < dv)
              acc_v[i][c] = fmaf(pj, __bfloat162float(sDO[j][dim]),
                                 acc_v[i][c]);
            if (dim < d)
              acc_k[i][c] = fmaf(dsj, __bfloat162float(sQ[j][dim]),
                                 acc_k[i][c]);
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

}  // namespace

// q: (BH, Sq, d), k: (BH/group, Sk, d), v: (BH/group, Sk, dv),
// dout: (BH, Sq, dv), bf16, contiguous; lse, dmat: (BH, Sq) f32;
// d, dv <= 128 and % 8 == 0 (checked by the Python wrapper).
// dq: (BH, Sq, d) f32.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* dmat,
                                      void* dq, int BH, int Sq, int Sk,
                                      int d, int dv, int group, float scale,
                                      float softcap, int causal, int window,
                                      void* stream) {
  dim3 grid((Sq + BR - 1) / BR, BH);
  flash_bwd_dq_kernel<<<grid, WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dmat),
      static_cast<float*>(dq), Sq, Sk, d, dv, group, scale, softcap, causal,
      window);
  return (int)cudaGetLastError();
}

// Same inputs; dk: (BH/group, Sk, d), dv: (BH/group, Sk, dv) f32, already
// summed over the group.
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* dmat,
                                       void* dk, void* dv_out, int BH,
                                       int Sq, int Sk, int d, int dv,
                                       int group, float scale, float softcap,
                                       int causal, int window, void* stream) {
  dim3 grid((Sk + BR - 1) / BR, BH / group);
  flash_bwd_dkv_kernel<<<grid, WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dmat),
      static_cast<float*>(dk), static_cast<float*>(dv_out), Sq, Sk, d, dv,
      group, scale, softcap, causal, window);
  return (int)cudaGetLastError();
}

// Tile machinery of the tensor-core attention kernels (flash_attention.cu,
// flash_attention_bwd.cu, paged_decode.cu): cp.async copies into
// 16-byte-padded shared rows, ldmatrix operand loads, mma.sync.m16n8k16
// bf16 products with f32 accumulators, and the attention mask.
//
// Layouts.  A tile of D-wide bf16 rows sits in shared memory with a row
// stride of LD = D + 8 elements: the 16 extra bytes put the eight rows of
// each 8x8 ldmatrix matrix in distinct banks.  A warp owns 16 rows of an
// accumulator; thread (g = lane / 4, t = lane % 4) holds, for each 8-column
// n-tile n, the elements (g, 8n + 2t + {0, 1}) in c[n][0..1] and
// (g + 8, 8n + 2t + {0, 1}) in c[n][2..3].

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

// The reference's finite mask sentinel (never -inf: see
// attention_common.cuh).
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; zero-fills when !pred (src is then
// not read, but must still be a valid address).
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// The same for 4 bytes (an f32 or an int32).
__device__ __forceinline__ void cp4(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b for one m16n8k16 tile (bf16 in, f32 accumulate).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of a product over the 16 columns kb*16.. of a 16 x N
// accumulator (n-tiles 2kb and 2kb+1): the accumulator layout of
// m16n8k16 is the A layout, two n-tiles per k-step.
template <int NT>
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4],
                                           const float (&c)[NT][4], int kb) {
  a[0] = pack(c[2 * kb][0], c[2 * kb][1]);
  a[1] = pack(c[2 * kb][2], c[2 * kb][3]);
  a[2] = pack(c[2 * kb + 1][0], c[2 * kb + 1][1]);
  a[3] = pack(c[2 * kb + 1][2], c[2 * kb + 1][3]);
}

// acc (16 x N) += A rows (16 x D, row-major in smem at a_base) . B^T, with
// B the rows b_base.. (N x D, row-major): S = Q K^T and its kin.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4],
                                        const __nv_bfloat16* a_base,
                                        const __nv_bfloat16* b_base,
                                        int lane) {
  constexpr int LD = D + 8;
  const uint32_t a_addr =
      smem_u32(a_base + (lane & 15) * LD + (lane >> 4) * 8);
  const uint32_t b_addr = smem_u32(
      b_base + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm4(a, a_addr + kk * 32);
#pragma unroll
    for (int nb = 0; nb < N / 16; ++nb) {
      uint32_t b[4];
      ldsm4(b, b_addr + (nb * 16 * LD + kk * 16) * 2);
      mma(acc[2 * nb], a, b[0], b[1]);
      mma(acc[2 * nb + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DO) += A (16 x 16, registers) . B, with B the 16 rows b_base..
// (row-major, LD-padded) at columns col0 .. col0 + DO: P V, dS K and kin.
template <int LD, int DO>
__device__ __forceinline__ void mma_ab(float (&acc)[DO / 8][4],
                                       const uint32_t (&a)[4],
                                       const __nv_bfloat16* b_base, int col0,
                                       int lane) {
  const uint32_t b_addr =
      smem_u32(b_base + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + col0 +
               (lane >> 4) * 8);
#pragma unroll
  for (int nd = 0; nd < DO / 16; ++nd) {
    uint32_t b[4];
    ldsm4t(b, b_addr + nd * 32);
    mma(acc[2 * nd], a, b[0], b[1]);
    mma(acc[2 * nd + 1], a, b[2], b[3]);
  }
}

// Async copy of `rows` D-wide bf16 rows from src (row stride D) into an
// LD-padded shared tile; rows at or past `valid` are zero-filled.
template <int D, int NTHREADS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int rows,
                                          int valid, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < rows * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool in = r < valid;
    cp16(dst + r * (D + 8) + c, in ? src + (size_t)r * D + c : src, in);
  }
}

// The reference's mask (_mask in src/repro/kernels/flash_attention.py),
// with the ragged ends of Sq and Sk masked too.
__device__ __forceinline__ bool pair_valid(int qpos, int kpos, int Sq,
                                           int Sk, int causal, int window) {
  bool v = qpos < Sq && kpos < Sk;
  if (causal) v = v && kpos <= qpos;
  if (window > 0) v = v && (qpos - kpos < window);
  return v;
}

}  // namespace tc

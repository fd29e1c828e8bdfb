// Plane-fused nibble matmul for Hopper (sm_90a), int8 tensor cores.
//
// Replaces: src/repro/kernels/nibble_matmul.py, fused_nibble_matmul_pallas
// (bodies _fused_kernel / _fused_scaled_kernel, helpers _plane_concat,
// _unpack_w4, _single_pass_dot).
//
// Computes the exact int8 x int8 product x (M,K) . w (K,N) the paper's way:
// the int8 activation tile is split inside the kernel into its nibble
// planes, lo = x & 0xF in [0,16) and hs = x - lo = hi << 4 in [-128,112]
// (both int8-exact; per byte, lo = x & 0x0F and hs = x & 0xF0), and both
// planes are multiplied by the SAME weight fragment held in registers from
// one shared-memory tile:  x.W = lo.W + hs.W.  Accumulation is int32 and
// exact.  Optional epilogue: (float(acc) * x_scale[m]) * w_scale[n],
// rounded once to bf16 (round to nearest even) or kept in f32.
//
// Weight layout: the kernel reads the weight N-major, wt[n][k] (the
// column-major "TN" B operand of the int8 MMA), which serving prepares
// once when the model is built.  Packed int4 weights come as wt[n/2][k]
// bytes (low nibble = even column n, high nibble = odd column), unpacked
// at the shared-memory tile store by shift, mask and sign-extend.
//
// What bounds it on an H100: at decode (M = number of slots, 4) the
// weight bytes: K*N int8 read once at 3.35 TB/s, versus 2*M*N*K int8
// operations at 1,979 TOP/s -- three orders of magnitude below the
// compute roof.  At prefill (M = 128) it is still weight-bytes bound.
// Design response (first, simple version): an M tile of 16 rows (one
// m16n8k32 MMA row block, so a 4-row decode wastes 12 rows of MMA, not
// 124), an N tile of 64 so that a 4096-wide projection spreads over 64
// blocks, 16-byte vector loads, and each weight byte loaded once per
// M tile.  Not yet done: cp.async/TMA pipelining, split-K for narrow N,
// wgmma.  Those are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;   // padded row (bytes): keeps 16B alignment,
                               // and B-fragment reads are bank-conflict free
constexpr int THREADS = 128;   // 4 warps, each owns 16 output columns

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Sign-extend the four 4-bit values held in the low nibbles of each byte.
__device__ __forceinline__ uint32_t sext4(uint32_t v) {
  v &= 0x0F0F0F0Fu;
  return v | ((v & 0x08080808u) * 0x1Eu);   // 0x08 * 0x1E = 0xF0 per byte
}

template <int OUT_KIND, bool PACKED>   // OUT_KIND: 0 int32, 1 bf16, 2 f32
__global__ void __launch_bounds__(THREADS)
nibble_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 void* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int8_t sX[BM][LDS];
  __shared__ __align__(16) int8_t sW[BN][LDS];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // activation tile: 16 rows x 64 bytes = 64 chunks of 16 bytes
    if (tid < BM * (BK / 16)) {
      const int r = tid >> 2, c = (tid & 3) * 16;
      int4 v = make_int4(0, 0, 0, 0);
      if (m0 + r < M && k0 + c < K)
        v = *reinterpret_cast<const int4*>(x + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<int4*>(&sX[r][c]) = v;
    }
    // weight tile, N-major: 64 rows x 64 bytes
    if (!PACKED) {
#pragma unroll
      for (int i = tid; i < BN * (BK / 16); i += THREADS) {
        const int r = i >> 2, c = (i & 3) * 16;
        int4 v = make_int4(0, 0, 0, 0);
        if (n0 + r < N && k0 + c < K)
          v = *reinterpret_cast<const int4*>(wt + (size_t)(n0 + r) * K + k0 + c);
        *reinterpret_cast<int4*>(&sW[r][c]) = v;
      }
    } else {
      // 32 packed rows x 64 bytes = 128 chunks: one per thread, each
      // unpacked into an even and an odd weight column
      const int r = tid >> 2, c = (tid & 3) * 16;
      const int j = (n0 >> 1) + r;
      int4 v = make_int4(0, 0, 0, 0);
      if (2 * j < N && k0 + c < K)
        v = *reinterpret_cast<const int4*>(wt + (size_t)j * K + k0 + c);
      int4 lo, hi;
      lo.x = (int)sext4((uint32_t)v.x);
      lo.y = (int)sext4((uint32_t)v.y);
      lo.z = (int)sext4((uint32_t)v.z);
      lo.w = (int)sext4((uint32_t)v.w);
      hi.x = (int)sext4((uint32_t)v.x >> 4);
      hi.y = (int)sext4((uint32_t)v.y >> 4);
      hi.z = (int)sext4((uint32_t)v.z >> 4);
      hi.w = (int)sext4((uint32_t)v.w >> 4);
      *reinterpret_cast<int4*>(&sW[2 * r][c]) = lo;
      *reinterpret_cast<int4*>(&sW[2 * r + 1][c]) = hi;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4], lo[4], hs[4];
      a[0] = *reinterpret_cast<const uint32_t*>(&sX[g][kk + t * 4]);
      a[1] = *reinterpret_cast<const uint32_t*>(&sX[g + 8][kk + t * 4]);
      a[2] = *reinterpret_cast<const uint32_t*>(&sX[g][kk + 16 + t * 4]);
      a[3] = *reinterpret_cast<const uint32_t*>(&sX[g + 8][kk + 16 + t * 4]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo[i] = a[i] & 0x0F0F0F0Fu;   // low nibble plane, [0, 16)
        hs[i] = a[i] & 0xF0F0F0F0u;   // high plane pre-shifted: hi << 4
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int nb = warp * 16 + j * 8 + g;
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&sW[nb][kk + t * 4]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&sW[nb][kk + 16 + t * 4]);
        mma_s8(acc[j], lo, b0, b1);   // one weight fragment serves
        mma_s8(acc[j], hs, b0, b1);   // both nibble planes
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + g + (i >= 2 ? 8 : 0);
      const int n = n0 + warp * 16 + j * 8 + t * 2 + (i & 1);
      if (m >= M || n >= N) continue;
      const size_t o = (size_t)m * N + n;
      if (OUT_KIND == 0) {
        static_cast<int*>(out)[o] = acc[j][i];
      } else {
        // two IEEE multiplies in the reference's order, no contraction
        float v = __fmul_rn(__int2float_rn(acc[j][i]), xs[m]);
        v = __fmul_rn(v, ws[n]);
        if (OUT_KIND == 1)
          static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
        else
          static_cast<float*>(out)[o] = v;
      }
    }
  }
}

template <int OUT_KIND, bool PACKED>
cudaError_t launch(const int8_t* x, const int8_t* wt, const float* xs,
                   const float* ws, void* out, int M, int N, int K,
                   cudaStream_t stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  nibble_mm_kernel<OUT_KIND, PACKED>
      <<<grid, THREADS, 0, stream>>>(x, wt, xs, ws, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x: int8 (M, K) row-major; wt: int8 (N, K), or packed int4 (N/2, K);
// K % 16 == 0, 16-byte aligned pointers (checked by the Python wrapper).
// out_kind 0: int32 out, scales unused; 1: bf16 out; 2: f32 out.
extern "C" int nibble_matmul(const void* x, const void* wt, const void* xs,
                             const void* ws, void* out, int M, int N, int K,
                             int packed, int out_kind, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(wt);
  auto xsp = static_cast<const float*>(xs);
  auto wsp = static_cast<const float*>(ws);
  cudaError_t err;
  if (packed) {
    if (out_kind == 0) err = launch<0, true>(xp, wp, xsp, wsp, out, M, N, K, s);
    else if (out_kind == 1) err = launch<1, true>(xp, wp, xsp, wsp, out, M, N, K, s);
    else err = launch<2, true>(xp, wp, xsp, wsp, out, M, N, K, s);
  } else {
    if (out_kind == 0) err = launch<0, false>(xp, wp, xsp, wsp, out, M, N, K, s);
    else if (out_kind == 1) err = launch<1, false>(xp, wp, xsp, wsp, out, M, N, K, s);
    else err = launch<2, false>(xp, wp, xsp, wsp, out, M, N, K, s);
  }
  return (int)err;
}

// Plane-fused nibble matmul for Hopper (sm_90a), int8 tensor cores.
//
// Replaces: src/repro/kernels/nibble_matmul.py:161,
// fused_nibble_matmul_pallas (bodies _fused_kernel / _fused_scaled_kernel,
// helpers _plane_concat, _unpack_w4, _single_pass_dot).
//
// Computes the exact int8 x int8 product x (M,K) . w (K,N) the paper's way:
// the int8 activation is split inside the kernel into its nibble planes,
// lo = x & 0x0F in [0,16) and hs = x & 0xF0 = hi << 4 in [-128,112] (both
// int8-exact, lo + hs = x), and both planes are multiplied by the SAME
// weight fragment held in registers:  x.W = lo.W + hs.W.  Accumulation is
// int32 and exact.  Optional epilogue: (float(acc) * x_scale[m]) *
// w_scale[n] as two IEEE multiplies in that order, rounded once to bf16
// (round to nearest even) or kept in f32.
//
// Weight layout: wt[n][k], N-major (the "col" B operand of the int8 MMA),
// prepared once when the model is built.  Packed int4 weights come as
// wt[n/2][k] bytes (low nibble = even column, high nibble = odd column);
// the raw packed bytes are staged and unpacked by shift, mask and sign
// extension when the B fragment is read from shared memory.
//
// What bounds it on an H100: the weight bytes.  At decode (M = 4 slots)
// one yi-6b layer's seven projections read 173 MB of int8 weight, 52 us
// at 3.35 TB/s, against 2*M*N*K int8 operations three orders of magnitude
// under the tensor-core roof.  At prefill (128, 4096, 11008) the weight is
// 45 MB (13.5 us) against 11.5 G multiply-adds for the two planes, ~12 us
// at the int8 peak: both roofs are near, and each weight byte must cross
// from memory once per 64 rows, not once per 16.  Measured (PERF.md): the
// decode layer takes ~1.8x its byte bound; at prefill the kernel runs its
// two planes' MMAs at the rate torch._int_mm reaches for one, so the second
// plane is what it loses there.
//
// Design:
// * A block owns BN = 64 output columns, a row tile and a K range
//   [z*k_chunk, min(K, (z+1)*k_chunk)) chosen by the caller's plan
//   (nibble_plan in kernels/nibble_matmul.py): K is split until the card
//   holds about four blocks per SM, or until a tile's splits fill one
//   cluster (below; N = 512 gets 8 x 8 blocks).
// * The K range is walked in tiles of BK = 128 bytes per row (whole
//   128-byte lines) through a ring of STAGES = 4 shared-memory stages
//   filled by cp.async.cg 16-byte copies: each thread keeps 12-20 copies
//   in flight, ~37 KB per block at decode.  Ragged rows, columns and K are
//   zero-filled by the copy (src-size 0).
// * Row tiles (struct Warps): 8 rows at M <= 8, where the two planes share
//   one MMA: rows 0-7 of the m16n8k32 A operand are the lo plane and rows
//   8-15 the hs plane of the same 8 activation rows, summed in the
//   epilogue (the paper's broadcast-operand reuse in one instruction, half
//   the MMAs).  16 rows at M <= 16.  64 rows above: 8 warps in two K
//   groups, each warp 32 rows x 32 columns, A fragments by ldmatrix, split
//   into their planes once for four B fragments, two MMAs (lo, hs) per A
//   and B fragment.
// * Split K without a workspace: the splits of one output tile are one
//   thread-block cluster (at most 8 blocks).  Each block leaves its int32
//   partial tile in its shared memory; block r reads slice r of every
//   block's tile through distributed shared memory, sums it, and applies
//   the epilogue once.  Integer sums are exact, so the result equals the
//   plain version's bit for bit; nothing is zeroed, no atomics.
// * Rows of shared memory are padded to 144 bytes: cp.async stores,
//   ldmatrix and the 32-bit B-fragment reads are all bank-conflict free.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BK = 128;         // K bytes per stage
constexpr int LDS = BK + 16;    // padded shared-memory row (bytes)
constexpr int STAGES = 4;
constexpr int BN = 64;          // output columns per block
constexpr int MAX_SPLITS = 8;   // a cluster holds the splits of one tile

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* smem) {
  const uint32_t p = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(p));
}

// 16-byte global -> shared copy, zero-filled when !valid (src-size 0; the
// source address must still be a mapped one).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  const uint32_t p = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(p), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Sign-extend the four 4-bit values held in the low nibbles of each byte.
__device__ __forceinline__ uint32_t sext4(uint32_t v) {
  v &= 0x0F0F0F0Fu;
  return v | ((v & 0x08080808u) * 0x1Eu);   // 0x08 * 0x1E = 0xF0 per byte
}

// Shared memory of a block of RT rows (int8 layout).
template <int RT>
struct Tile {
  static constexpr int STAGE_BYTES = (RT + BN) * LDS;
  static constexpr int SMEM = STAGES * STAGE_BYTES;
};

// Stage one K tile [k0, k0 + BK) of the activation rows [m0, m0 + RT) and
// the weight rows of columns [n0, n0 + BN) into shared memory.
template <int RT, bool PACKED, int NTH>
__device__ __forceinline__ void load_stage(
    int8_t* sx, int8_t* sw, const int8_t* __restrict__ x,
    const int8_t* __restrict__ wt, int M, int N, int K, int m0, int n0,
    int k0, int k_end) {
  constexpr int CPR = BK / 16;                 // 16-byte chunks per row
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = tid; i < RT * CPR; i += NTH) {
    const int r = i / CPR, c = (i % CPR) * 16;
    const bool ok = m0 + r < M && k0 + c < k_end;
    cp_async16(sx + r * LDS + c,
               ok ? x + (size_t)(m0 + r) * K + k0 + c : x, ok);
  }
  constexpr int WR = PACKED ? BN / 2 : BN;     // weight rows staged
  const int w0 = PACKED ? n0 / 2 : n0;
  const int w_rows = PACKED ? (N + 1) / 2 : N;
#pragma unroll
  for (int i = tid; i < WR * CPR; i += NTH) {
    const int r = i / CPR, c = (i % CPR) * 16;
    const bool ok = w0 + r < w_rows && k0 + c < k_end;
    cp_async16(sw + r * LDS + c,
               ok ? wt + (size_t)(w0 + r) * K + k0 + c : wt, ok);
  }
}

// The B fragment (k 0-15 and 16-31 of column nb) at K offset kk.
template <bool PACKED>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const int8_t* sw, int nb, int kk,
                                       int t) {
  if (!PACKED) {
    b0 = *reinterpret_cast<const uint32_t*>(sw + nb * LDS + kk + t * 4);
    b1 = *reinterpret_cast<const uint32_t*>(sw + nb * LDS + kk + 16 + t * 4);
  } else {
    const int8_t* row = sw + (nb >> 1) * LDS;
    const int sh = (nb & 1) * 4;               // odd column: high nibbles
    b0 = sext4(*reinterpret_cast<const uint32_t*>(row + kk + t * 4) >> sh);
    b1 = sext4(*reinterpret_cast<const uint32_t*>(row + kk + 16 + t * 4)
               >> sh);
  }
}

// Output element (m, n) = v, through the epilogue of OUT_KIND.
template <int OUT_KIND>
__device__ __forceinline__ void emit(void* out, int m, int n, int N, int v,
                                     const float* xs, long long xs_stride,
                                     const float* ws, long long ws_stride) {
  const size_t o = (size_t)m * N + n;
  if (OUT_KIND == 0) {
    static_cast<int*>(out)[o] = v;
  } else {
    // two IEEE multiplies in the reference's order, no contraction
    const float sx = xs ? xs[m * xs_stride] : 1.0f;
    const float sn = ws ? ws[n * ws_stride] : 1.0f;
    const float f = __fmul_rn(__fmul_rn(__int2float_rn(v), sx), sn);
    if (OUT_KIND == 1)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(f);
    else
      static_cast<float*>(out)[o] = f;
  }
}

// The warps of a block of RT rows.  8: 4 warps x 16 columns, both planes
// in one MMA.  16: 4 warps x 16 columns, one MMA per plane.  64: two K
// groups of 2 x 2 warps (8 warps); each warp owns 32 rows x 32 columns
// (MT = 2 MMA row blocks, NT = 4 column blocks, so an A fragment is split
// into its planes once for four B fragments) over half of every stage's K,
// and the two groups' sums meet in shared memory at the end.
template <int RT>
struct Warps {
  static constexpr bool PAIR = RT == 8;        // lo / hs in one MMA
  static constexpr int KG = RT == 64 ? 2 : 1;  // K groups of 4 warps
  static constexpr int THREADS = 128 * KG;
  static constexpr int WARPS_M = RT == 64 ? 2 : 1;
  static constexpr int WN = BN / (4 / WARPS_M);        // columns per warp
  static constexpr int NT = WN / 8;
  static constexpr int WM = RT / WARPS_M;              // rows per warp
  static constexpr int MT = PAIR ? 1 : WM / 16;
  static constexpr int MIN_BLOCKS = RT == 64 ? 3 : 4;  // per SM
};

template <int RT, int OUT_KIND, bool PACKED>
__global__ void __launch_bounds__(Warps<RT>::THREADS, Warps<RT>::MIN_BLOCKS)
nibble_mm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                 const float* __restrict__ xs, long long xs_stride,
                 const float* __restrict__ ws, long long ws_stride,
                 void* __restrict__ out, int M, int N, int K, int k_chunk) {
  using W_ = Warps<RT>;
  constexpr bool PAIR = W_::PAIR;
  constexpr int KG = W_::KG, NTH = W_::THREADS, NT = W_::NT, MT = W_::MT;
  constexpr int WN = W_::WN, WM = W_::WM, KS = BK / KG / 32;  // k32 steps
  constexpr int NACC = MT * NT * 4;
  extern __shared__ __align__(16) int8_t smem[];
  using T = Tile<RT>;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kg = warp / 4, wq = warp % 4;       // K group, warp in group
  const int wr = (wq / (4 / W_::WARPS_M)) * WM;   // warp's first row, column
  const int wc = (wq % (4 / W_::WARPS_M)) * WN;
  const int m0 = blockIdx.x * RT, n0 = blockIdx.y * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  auto sx = [&](int s) { return smem + s * T::STAGE_BYTES; };
  auto sw = [&](int s) { return smem + s * T::STAGE_BYTES + RT * LDS; };

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_tiles)
      load_stage<RT, PACKED, NTH>(sx(s), sw(s), x, wt, M, N, K, m0, n0,
                                  k_begin + s * BK, k_end);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();           // tile kt landed; stage kt-1 free for reuse
    {
      const int nt = kt + STAGES - 1;
      if (nt < n_tiles) {
        const int s = nt % STAGES;
        load_stage<RT, PACKED, NTH>(sx(s), sw(s), x, wt, M, N, K, m0, n0,
                                    k_begin + nt * BK, k_end);
      }
      cp_async_commit();
    }
    const int8_t* X = sx(kt % STAGES);
    const int8_t* W = sw(kt % STAGES);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int kk = (kg * KS + ks) * 32;
      uint32_t b[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        load_b<PACKED>(b[j][0], b[j][1], W, wc + j * 8 + g, kk, t);
      if (PAIR) {
        const uint32_t v0 =
            *reinterpret_cast<const uint32_t*>(X + g * LDS + kk + t * 4);
        const uint32_t v1 =
            *reinterpret_cast<const uint32_t*>(X + g * LDS + kk + 16 + t * 4);
        // rows 0-7: lo plane; rows 8-15: hs plane of the same rows
        const uint32_t a[4] = {v0 & 0x0F0F0F0Fu, v0 & 0xF0F0F0F0u,
                               v1 & 0x0F0F0F0Fu, v1 & 0xF0F0F0F0u};
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[0][j], a, b[j][0], b[j][1]);
      } else {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t a[4], lo[4], hs[4];
          ldmatrix_x4(a, X + (wr + i * 16 + (lane & 15)) * LDS + kk
                             + (lane >> 4) * 16);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            lo[c] = a[c] & 0x0F0F0F0Fu;      // low nibble plane, [0, 16)
            hs[c] = a[c] & 0xF0F0F0F0u;      // high plane pre-shifted
          }
          // one weight fragment serves both planes (the lo pass first,
          // so that no MMA waits on the one before it)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], lo, b[j][0], b[j][1]);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], hs, b[j][0], b[j][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  int* red = reinterpret_cast<int*>(smem);
  if (KG > 1) {              // K group 1 hands its sums to group 0
    __syncthreads();
    const int u = tid % 128;
    if (kg == 1) {
#pragma unroll
      for (int r = 0; r < NACC; ++r) red[r * 128 + u] = (&acc[0][0][0])[r];
    }
    __syncthreads();
    if (kg == 0) {
#pragma unroll
      for (int r = 0; r < NACC; ++r) (&acc[0][0][0])[r] += red[r * 128 + u];
    }
  }

  // this block's result (K group 0), or its part of a split K
  auto for_each = [&](auto&& f) {
    if (kg != 0) return;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (PAIR && c >= 2) continue;
          const int m = m0 + (PAIR ? g : wr + i * 16 + g + (c >= 2 ? 8 : 0));
          const int n = n0 + wc + j * 8 + t * 2 + (c & 1);
          if (m < M && n < N)
            f(m, n, PAIR ? acc[i][j][c] + acc[i][j][(c + 2) & 3]
                         : acc[i][j][c]);
        }
  };
  if (gridDim.z == 1) {
    for_each([&](int m, int n, int v) {
      emit<OUT_KIND>(out, m, n, N, v, xs, xs_stride, ws, ws_stride);
    });
    return;
  }
  // split K: the splits of this tile form one cluster.  Each block leaves
  // its partial tile in its own shared memory; block r sums slice r of the
  // tile over the cluster's blocks (distributed shared memory) and applies
  // the epilogue to the total.
  constexpr int TR = PAIR ? 8 : RT, E = TR * BN;
  __syncthreads();                             // pipeline buffers free
  for_each([&](int m, int n, int v) { red[(m - m0) * BN + n - n0] = v; });
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int S = gridDim.z, r = blockIdx.z;
  const int per = (E + S - 1) / S, e_end = min(E, (r + 1) * per);
  for (int e = r * per + tid; e < e_end; e += NTH) {
    const int m = m0 + e / BN, n = n0 + e % BN;
    if (m >= M || n >= N) continue;
    int sum = 0;
    for (int q = 0; q < S; ++q) sum += cl.map_shared_rank(red, q)[e];
    emit<OUT_KIND>(out, m, n, N, sum, xs, xs_stride, ws, ws_stride);
  }
  cl.sync();                       // keep every part alive until it is read
}

template <int RT, int OUT_KIND, bool PACKED>
int launch(const int8_t* x, const int8_t* wt, const float* xs,
           long long xs_stride, const float* ws, long long ws_stride,
           void* out, int M, int N, int K, int k_chunk, cudaStream_t stream) {
  auto kernel = nibble_mm_kernel<RT, OUT_KIND, PACKED>;
  constexpr int smem = Tile<RT>::SMEM;
  static bool attr = false;              // once per instantiation
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid((M + RT - 1) / RT, (N + BN - 1) / BN,
            (K + k_chunk - 1) / k_chunk);
  if (grid.y > 65535 || grid.z > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Warps<RT>::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = grid.z;        // the splits of one tile
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, x, wt, xs, xs_stride, ws,
                                     ws_stride, out, M, N, K, k_chunk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int RT>
int dispatch(const int8_t* x, const int8_t* wt, const float* xs,
             long long xs_stride, const float* ws, long long ws_stride,
             void* out, int M, int N, int K, int packed, int out_kind,
             int k_chunk, cudaStream_t s) {
#define NIBBLE_LAUNCH(KIND, PK)                                          \
  return launch<RT, KIND, PK>(x, wt, xs, xs_stride, ws, ws_stride, out, \
                              M, N, K, k_chunk, s)
  if (packed) {
    if (out_kind == 0) NIBBLE_LAUNCH(0, true);
    if (out_kind == 1) NIBBLE_LAUNCH(1, true);
    NIBBLE_LAUNCH(2, true);
  }
  if (out_kind == 0) NIBBLE_LAUNCH(0, false);
  if (out_kind == 1) NIBBLE_LAUNCH(1, false);
  NIBBLE_LAUNCH(2, false);
#undef NIBBLE_LAUNCH
}

}  // namespace

// x: int8 (M, K) row-major; wt: int8 (N, K), or packed int4 (N/2, K);
// K % 16 == 0 and 16-byte aligned pointers (checked by the Python wrapper).
// out_kind 0: int32 out, scales unused; 1: bf16 out; 2: f32 out.  xs[m *
// xs_stride] and ws[n * ws_stride] are the f32 scales (a null pointer is a
// scale of 1; stride 0 broadcasts one value).  rows (8, 16 or 64) is the
// block's row tile and k_chunk (a multiple of 128) the K range of one
// split, at most 8 splits; both are chosen by the caller.
extern "C" int nibble_matmul(const void* x, const void* wt, const void* xs,
                             long long xs_stride, const void* ws,
                             long long ws_stride, void* out, int M, int N,
                             int K, int packed, int out_kind, int rows,
                             int k_chunk, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k_chunk < BK || k_chunk % BK != 0 || K % 16 != 0)
    return (int)cudaErrorInvalidValue;
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(wt);
  auto xsp = static_cast<const float*>(xs);
  auto wsp = static_cast<const float*>(ws);
  switch (rows) {
    case 8: return dispatch<8>(xp, wp, xsp, xs_stride, wsp, ws_stride, out,
                               M, N, K, packed, out_kind, k_chunk, s);
    case 16: return dispatch<16>(xp, wp, xsp, xs_stride, wsp, ws_stride, out,
                                 M, N, K, packed, out_kind, k_chunk, s);
    case 64: return dispatch<64>(xp, wp, xsp, xs_stride, wsp, ws_stride, out,
                                 M, N, K, packed, out_kind, k_chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// LUT-array multiplier for Hopper (sm_90a): int8 x int8 -> exact int32 by
// selection from tables of pre-scaled copies of the shared operand, no
// partial-product multiplier.
//
// Replaces: src/repro/kernels/lut_matmul.py:87, lut_matmul_pallas (body
// _lut_matmul_kernel).
//
// The paper's LUT design precomputes the sixteen scaled copies v * a of
// the operand a that is shared (broadcast) and lets the other operand's
// nibbles select among them.  In x @ w, x[m][k] is shared by all N
// columns and w[k][n] by all M rows.  The TPU kernel tables the weight,
// because its 128-row tiles make M large.  At decode on this card M is
// 1-4 while N is 512-11008: tabling the weight would cost 32 table
// entries per weight element for 2*M uses, so here the table holds the
// activation, and each weight element costs 2*M lookups and no stores.
// With w = w_lo + 16 * w_hi_signed, w_lo = w & 15, w_hi = (w >> 4) & 15:
//   t_lo[v] = v * x                 v in [0, 16)
//   t_hi[v] = (v_signed << 4) * x   v_signed = v - 16 * (v >= 8)
//   x * w   = t_lo[w_lo] + t_hi[w_hi]            (exact, |entry| <= 2^14)
// The tables are built by shifts and additions and stored as int16; the
// 16:1 mux of the hardware is an indexed load from shared memory.
//
// What bounds it on an H100: the function moves M*K + K*N + 4*M*N bytes;
// at decode (one yi-6b layer, M = 4) that is 173 MB of int8 weights, 52 us
// at 3.35 TB/s, the floor.  It does 2*M*K*N table lookups: 8-byte shared-
// memory loads, each serving four rows, about two cycles each per warp,
// and about nine integer instructions per weight element per four rows.
// Those, not the bytes, set its pace: ~0.18 ms of device time per decode
// layer (3.5x the byte floor) and ~0.94 ms at (128, 4096, 11008), where
// the lookups alone come to ~0.8 ms (PERF.md has the measurements).
//
// Design:
// * One thread per output column n (256 columns per block), a block tile
//   of RM rows (4, 8 or 16), and a K range [z*k_chunk, (z+1)*k_chunk)
//   per blockIdx.z: split K, so that N = 512 projections still fill the
//   132 SMs.  Partial sums are added to out (zeroed first) with int32
//   atomics; integer addition is exact and order-free, so the result is
//   bit-for-bit the same whatever order the blocks run in.
// * The block walks its K range in tiles of KT = 256 / RM.  Per tile the
//   table holds, for every (k, row group of 4), 2 x 16 entries of 4 rows:
//   tab[kk][g][lo|hi][position][row], position = nibble ^ (kk & 7).  A
//   warp's lanes (32 columns) all look up the same k, so its 8-byte loads
//   hit one 128-byte table row: conflict-free, same words broadcast.  The
//   XOR spreads the builders' stores, which run over k, across the banks.
// * Two rows share a 32-bit word (see pack2), so one add of a t_lo word
//   and a t_hi word serves two rows: about 9 integer instructions and two
//   8-byte lookups per weight element at M = 4.
// * Each thread reads its column's K run of wt (N-major) with 16-byte
//   loads, the next tile's loads in flight while it selects on this one;
//   the table is double-buffered, so one barrier per tile suffices.
// * Every edge is masked: rows >= M, columns >= N, k >= the range's end.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // one output column per thread
constexpr int BN = THREADS;           // columns per block

__device__ __forceinline__ int32_t shl(int32_t v, int s) {
  return (int32_t)((uint32_t)v << s);
}

// Two rows' int16 entries in one 32-bit word: the even row in the low
// half, biased to be non-negative, the odd row in the high half as is.
// Then a word from t_lo plus a word from t_hi never carries out of the low
// half (3825 + 32640 < 2^16), the high half of the sum is the odd row's
// product exactly (|.| < 2^15), and the even row's sum is recovered at
// the end as S - (H << 16) - steps * (BIAS_LO + BIAS_HI), exact mod 2^32.
constexpr int32_t BIAS_LO = 1920;     // -min of v * x
constexpr int32_t BIAS_HI = 16256;    // -min of (v_signed << 4) * x
__device__ __forceinline__ uint32_t pack2(int32_t even, int32_t odd) {
  return __byte_perm((uint32_t)even, (uint32_t)odd, 0x5410);
}

// The activation values one builder thread needs: rows 4g..4g+3 at one k.
template <int RM>
__device__ __forceinline__ void load_x(int32_t (&xr)[4],
                                       const int8_t* __restrict__ x, int M,
                                       int K, int m0, int k0, int k_end) {
  constexpr int KT = 256 / RM;
  const int e = threadIdx.x;
  const int kk = (e >> 2) % KT, g = (e >> 2) / KT;
  const int k = k0 + kk;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + 4 * g + r;
    xr[r] = (m < M && k < k_end) ? (int32_t)x[(size_t)m * K + k] : 0;
  }
}

// Thread e builds one quarter of the (kk, g) table block: part & 1 picks
// the nibble values 0-7 or 8-15, part >> 1 the lo or hi table.  Values are
// made by additions from a shifted start (0, 8x; 0, -(x << 7)).
template <int RM>
__device__ __forceinline__ void build_tables(uint2* __restrict__ tab,
                                             const int32_t (&xr)[4]) {
  constexpr int KT = 256 / RM, G = RM / 4;
  const int e = threadIdx.x;
  const int part = e & 3, kk = (e >> 2) % KT, g = (e >> 2) / KT;
  const bool hi = part >> 1, upper = part & 1;
  int32_t val[4], step[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    step[r] = hi ? shl(xr[r], 4) : xr[r];
    val[r] = !upper ? 0 : hi ? -shl(xr[r], 7) : shl(xr[r], 3);
    if (r % 2 == 0) val[r] += hi ? BIAS_HI : BIAS_LO;
  }
  const int f = kk & 7;
  uint2* dst = tab + (kk * G + g) * 32 + (hi ? 16 : 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int v = (upper ? 8 : 0) + i;
    dst[v ^ f] = make_uint2(pack2(val[0], val[1]), pack2(val[2], val[3]));
#pragma unroll
    for (int r = 0; r < 4; ++r) val[r] += step[r];
  }
}

// One tile of this thread's column: KT bytes, 16-byte loads where the run
// is whole and aligned, else bytes (ragged K, the range's last tile).
template <int NW>
__device__ __forceinline__ void load_w(uint32_t (&w)[NW],
                                       const int8_t* __restrict__ col,
                                       int k0, int valid, bool vec) {
  if (vec && valid == NW * 4) {
    const uint4* p = reinterpret_cast<const uint4*>(col + k0);
#pragma unroll
    for (int i = 0; i < NW / 4; ++i) {
      const uint4 q = __ldg(p + i);
      w[4 * i] = q.x;
      w[4 * i + 1] = q.y;
      w[4 * i + 2] = q.z;
      w[4 * i + 3] = q.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int j = 4 * i + b;
      if (j < valid) word |= (uint32_t)(uint8_t)col[k0 + j] << (8 * b);
    }
    w[i] = word;
  }
}

// Selection: the weight's two nibble patterns index the activation tables.
// Four weight bytes at a time, each nibble becomes a byte offset into its
// 128-byte table row, ((nibble ^ (kk & 7)) * 8), by one shift and one LOP3.
// S and H hold the packed sums of the row pairs (4g, 4g+1), (4g+2, 4g+3).
template <int RM>
__device__ __forceinline__ void select_tile(const uint2* __restrict__ tab,
                                            const uint32_t (&w)[64 / RM],
                                            uint32_t (&S)[RM / 2],
                                            int32_t (&H)[RM / 2]) {
  constexpr int KT = 256 / RM, G = RM / 4;
  const char* base = reinterpret_cast<const char*>(tab);
#pragma unroll
  for (int i = 0; i < KT / 4; ++i) {
    const uint32_t swz = (i & 1) ? 0x38302820u : 0x18100800u;
    const uint32_t lo8 = ((w[i] << 3) & 0x78787878u) ^ swz;
    const uint32_t hi8 = ((w[i] >> 1) & 0x78787878u) ^ swz;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int kk = 4 * i + b;
      const uint32_t off_lo = (lo8 >> (8 * b)) & 0xffu;
      const uint32_t off_hi = (hi8 >> (8 * b)) & 0xffu;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const char* blk = base + (kk * G + g) * 256;
        const uint2 a = *reinterpret_cast<const uint2*>(blk + off_lo);
        const uint2 c = *reinterpret_cast<const uint2*>(blk + 128 + off_hi);
        const uint32_t p0 = a.x + c.x, p1 = a.y + c.y;
        S[2 * g] += p0;
        S[2 * g + 1] += p1;
        H[2 * g] += (int32_t)p0 >> 16;
        H[2 * g + 1] += (int32_t)p1 >> 16;
      }
    }
  }
}

template <int RM>
__global__ void __launch_bounds__(THREADS)
lut_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                  int32_t* __restrict__ out, int M, int N, int K,
                  int k_chunk, bool vec) {
  constexpr int KT = 256 / RM, NW = KT / 4;
  static_assert(RM % 4 == 0 && KT % 16 == 0, "tile shape");
  __shared__ __align__(16) uint2 tab[2][KT * (RM / 4) * 32];  // 2 x 16 KB

  const int m0 = blockIdx.x * RM;
  const int n = blockIdx.y * BN + threadIdx.x;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(K, k_begin + k_chunk);
  const int n_tiles = (k_end - k_begin + KT - 1) / KT;
  const bool col_ok = n < N;
  const int8_t* col = wt + (size_t)(col_ok ? n : 0) * K;

  uint32_t S[RM / 2];
  int32_t H[RM / 2];
#pragma unroll
  for (int j = 0; j < RM / 2; ++j) S[j] = 0, H[j] = 0;
  uint32_t wcur[NW], wnext[NW];
  int32_t xr[4];

  load_x<RM>(xr, x, M, K, m0, k_begin, k_end);
  load_w(wcur, col, k_begin, col_ok ? min(KT, k_end - k_begin) : 0, vec);
  build_tables<RM>(tab[0], xr);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int k1 = k_begin + (t + 1) * KT;
    const bool more = t + 1 < n_tiles;
    if (more) {                       // next tile's loads in flight
      load_x<RM>(xr, x, M, K, m0, k1, k_end);
      load_w(wnext, col, k1, col_ok ? min(KT, k_end - k1) : 0, vec);
    }
    select_tile<RM>(tab[t & 1], wcur, S, H);
    if (more) build_tables<RM>(tab[(t + 1) & 1], xr);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NW; ++i) wcur[i] = wnext[i];
  }

  if (!col_ok) return;
  const uint32_t bias = (uint32_t)(n_tiles * KT) * (BIAS_LO + BIAS_HI);
#pragma unroll
  for (int j = 0; j < RM / 2; ++j) {
    const int m = m0 + 2 * j;
    const int32_t even = (int32_t)(S[j] - ((uint32_t)H[j] << 16) - bias);
    if (m < M) atomicAdd(out + (size_t)m * N + n, even);
    if (m + 1 < M) atomicAdd(out + (size_t)(m + 1) * N + n, H[j]);
  }
}

template <int RM>
int launch(const int8_t* x, const int8_t* wt, int32_t* out, int M, int N,
           int K, int k_chunk, cudaStream_t stream) {
  constexpr int KT = 256 / RM;
  if (k_chunk < KT || k_chunk % KT != 0) return (int)cudaErrorInvalidValue;
  const bool vec = K % 16 == 0 && (reinterpret_cast<uintptr_t>(wt) & 15) == 0;
  dim3 grid((M + RM - 1) / RM, (N + BN - 1) / BN,
            (K + k_chunk - 1) / k_chunk);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  lut_matmul_kernel<RM><<<grid, THREADS, 0, stream>>>(x, wt, out, M, N, K,
                                                      k_chunk, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) int8 row-major; wt: (N, K) int8 row-major (the weight
// N-major); out: (M, N) int32, overwritten.  Any M, N, K >= 1.  rows (4,
// 8 or 16) is the block's row tile and k_chunk (a multiple of 256 / rows)
// the K range of one split; both are chosen by the caller.
extern "C" int lut_matmul(const void* x, const void* wt, void* out, int M,
                          int N, int K, int rows, int k_chunk, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(int32_t),
                                    s);
  if (err != cudaSuccess) return (int)err;
  auto xp = static_cast<const int8_t*>(x);
  auto wp = static_cast<const int8_t*>(wt);
  auto op = static_cast<int32_t*>(out);
  switch (rows) {
    case 4: return launch<4>(xp, wp, op, M, N, K, k_chunk, s);
    case 8: return launch<8>(xp, wp, op, M, N, K, k_chunk, s);
    case 16: return launch<16>(xp, wp, op, M, N, K, k_chunk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

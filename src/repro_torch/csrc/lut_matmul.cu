// LUT-array multiplier for Hopper (sm_90a): int8 x int8 -> exact int32 by
// selection from tables of pre-scaled weights, no partial-product
// multiplier.
//
// Replaces: src/repro/kernels/lut_matmul.py, lut_matmul_pallas (body
// _lut_matmul_kernel).
//
// The paper's LUT design (Fig. 1): for every weight w the sixteen scaled
// copies v * w are precomputed once (the "ResStrings") and the other
// operand's nibbles only select among them.  Per (k-tile, n-tile) of the
// weight this kernel builds the reference's two int16 tables in shared
// memory,
//   table_lo[v][n][k] = v * w[k][n]                 v in [0, 16)
//   table_hi[v][n][k] = (v_signed << 4) * w[k][n]   v_signed = v - 16 * (v >= 8)
// by repeated addition (shift and add only), and each thread then takes
// its activation's raw nibble patterns x & 15 and (x >> 4) & 15 and
// accumulates table_lo[x_lo] + table_hi[x_hi] in int32: the 16:1 mux of
// the hardware is an indexed load from shared memory.  The TPU kernel's
// one-hot matmul is its workaround for a missing mux and is not carried
// over.  Exact for all int8 inputs (|entries| <= 2^14 fit int16).
//
// What bounds it on an H100: the function moves M*K + K*N + 4*M*N bytes
// (at one yi-6b decode layer, M = 4: 173 MB of int8 weights, ~52 us at
// 3.35 TB/s), but the table build writes 32 int16 entries per weight
// element per M tile, so the kernel is bound by shared-memory stores, far
// above the byte roof.  That cost is the paper's point (Fig. 4: the LUT
// design spends area and power on the tables that the nibble design's
// logic reuse avoids); its time is recorded, not hidden.
// Design response (first, simple version): one block per (64-row M tile,
// 32-column N tile) walks K in 16-deep tiles; the weight is read N-major
// (wt[n][k], the layout serving prepares once), so the 16 bytes of one
// column's K tile are contiguous; table rows are padded to 18 entries so
// the 32 lanes of a warp (32 consecutive columns, one row) hit 32
// distinct banks on every lookup.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;              // rows per block
constexpr int BN = 32;              // columns per block (one per lane)
constexpr int BK = 16;              // K depth per tile
constexpr int THREADS = 256;
constexpr int RG = THREADS / BN;    // row groups: thread rows rg + RG * i
constexpr int LDT = BK + 2;         // padded table row (int16): 9 words

__global__ void __launch_bounds__(THREADS)
lut_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                  int32_t* __restrict__ out, int M, int N, int K) {
  __shared__ int16_t t_lo[16][BN][LDT];
  __shared__ int16_t t_hi[16][BN][LDT];
  __shared__ uint8_t sX[BM][BK];

  const int tid = threadIdx.x;
  const int col = tid % BN, rg = tid / BN;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  int32_t acc[BM / RG];
#pragma unroll
  for (int i = 0; i < BM / RG; ++i) acc[i] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();                 // previous tables fully consumed
    // ResStrings: sixteen scaled copies of each weight, by addition
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int nn = e / BK, kk = e % BK;
      const int n = n0 + nn, k = k0 + kk;
      const int16_t w = (n < N && k < K) ? wt[(size_t)n * K + k] : 0;
      const int16_t w16 = (int16_t)(w * 16);    // the fixed << 4
      int16_t lo = 0, hi = 0;
      t_lo[0][nn][kk] = 0;
      t_hi[0][nn][kk] = 0;
#pragma unroll
      for (int v = 1; v < 16; ++v) {
        lo = (int16_t)(lo + w);
        hi = v == 8 ? (int16_t)(-8 * w16) : (int16_t)(hi + w16);
        t_lo[v][nn][kk] = lo;
        t_hi[v][nn][kk] = hi;
      }
    }
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = e / BK, kk = e % BK;
      const int m = m0 + mm, k = k0 + kk;
      sX[mm][kk] = (m < M && k < K) ? (uint8_t)x[(size_t)m * K + k] : 0;
    }
    __syncthreads();
    // selection: the activation's nibble patterns index the tables
#pragma unroll
    for (int i = 0; i < BM / RG; ++i) {
      const int mm = rg + RG * i;
      if (m0 + mm >= M) break;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const uint8_t xv = sX[mm][kk];
        acc[i] += (int32_t)t_lo[xv & 15][col][kk] +
                  (int32_t)t_hi[xv >> 4][col][kk];
      }
    }
  }

  const int n = n0 + col;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < BM / RG; ++i) {
    const int m = m0 + rg + RG * i;
    if (m >= M) break;
    out[(size_t)m * N + n] = acc[i];
  }
}

}  // namespace

// x: (M, K) int8 row-major; wt: (N, K) int8 row-major (the weight
// N-major); out: (M, N) int32.  Any M, N, K >= 1.
extern "C" int lut_matmul(const void* x, const void* wt, void* out, int M,
                          int N, int K, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  lut_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
      static_cast<int32_t*>(out), M, N, K);
  return (int)cudaGetLastError();
}

// Paged decode attention for Hopper (sm_90a), the bf16 route: one query
// token per slot against shared K/V page pools, walking the page table
// itself, split over the cache (flash-decoding) and on bf16 tensor cores.
//
// Replaces: src/repro/kernels/flash_attention.py:182,
// paged_decode_attention_pallas (body _paged_decode_kernel), where the TPU
// scalar-prefetches the table into BlockSpec index maps and walks one
// page per grid step; here each block reads its span of the table itself.
//
// Computes, for slot b and KV head h, the G grouped query heads' attention
// over cache positions <= q_pos[b] (optional sliding window and tanh
// softcap), with the reference's casts: f32 scores of bf16 products, the
// finite -1e30 mask sentinel, f32 p into l and bf16(p) into the PV
// product, o = acc / max(l, 1e-30) in bf16.  Scores are kept in log2
// units (s * log2 e, the sentinel too) so that each exp is one exp2f.
// Only the order of the f32 sums and the max that p is rounded against
// differ from the reference.  f32 inputs take the SIMT route
// (attention_common.cuh, instantiated in attention_f32.cu).
//
// What bounds it on an H100: the live K/V rows, (q_pos + 1) x KVH x
// (d + dv) x 2 bytes per slot at 3.35 TB/s; ~1 FLOP per byte, far below
// the tensor cores' ridge.  At the serve shape (4 slots, KVH 4, d 128,
// ~150 live rows a slot) that is 0.6 MB, ~0.2 us: launch and load latency
// dominate; at 4 x 4096 rows it is 33.6 MB, 0.010 ms.
//
// Design:
// - Split-KV.  The grid is (n_split, B x KVH, head chunks of 16); the
//   n_split blocks of one (slot, KV head, chunk) each own a contiguous
//   span of `span` cache positions and form one thread-block cluster
//   (n_split <= 8).  kernels/flash_attention.py:paged_plan picks n_split
//   and span from host-known shapes only (table width x page size, B,
//   KVH, G, the SM count), never from q_pos, so no call reads the device.
//   A block walks only [max(span start, window start), min(span end,
//   q_pos + 1)); a block whose span holds no such position loads
//   nothing and leaves m = sentinel, l = 0.
// - Combine in one launch, exactly.  Each block's (m, l, acc) partials are
//   summed through distributed shared memory: m = max m_i, l = sum l_i
//   2^(m_i - m), acc likewise, o = acc / max(l, 1e-30).  No workspace, no
//   memset, no atomics; deterministic.  Every block reaches both cluster
//   barriers, an idle one with weight 2^(-1e30 log2 e - m) = 0, as a
//   masked page has in the reference.
// - Tensor cores for both products.  The chunk's query heads are the 16
//   rows of mma.sync.m16n8k16 (G = 8 fills half; grid z walks chunks of
//   16 heads, so any G works); S = Q K^T takes K rows by ldmatrix, and its
//   accumulator, as bf16(p), is the A operand of P V with V by
//   ldmatrix.trans (the layout trick of flash_attention.cu; the helpers
//   are mma_common.cuh's).
// - Keep the gather busy.  Block tiles of 64 positions; warp w owns rows
//   16w .. 16w + 15 of every tile and gathers them itself, row by row
//   through the table (any page size >= 1), with 16-byte cp.async into a
//   private ring of STAGES tiles, K and V as separate commit groups, so
//   the warps run barrier-free pipelines (~64 KB in flight a block).  The
//   span's table entries are read once into shared memory (in windows of
//   TAB entries for very long spans).  Each warp keeps its own online
//   softmax; the four warps' states are combined in shared memory before
//   the cluster's sum.
// - Widths.  Instances D = 64, 128, 256 by max(d, dv); d and dv are any
//   multiple of 8 <= D and the loads zero-fill columns past them, so the
//   pools are read in place: the wrapper never pads or copies them.
// - Tried on the H100 and not kept (chip_smoke.py's scaling line): a
//   4-stage ring at D <= 128 (146 KB of shared memory, so one block per
//   SM, and clusters of 8 no longer all fit at once: slower at 1024 and
//   4096 rows) and clusters of up to 16 splits (non-portable; slower at
//   both too).
// - What holds it back: a fixed cost of ~7 us a call in a CUDA graph
//   (launch, the q_pos / table round trip before the gather, the cluster
//   combine), and at long caches the gather's rate, ~2.3 TB/s.

#include <cooperative_groups.h>

#include "mma_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tc;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float MASKED = NEG_INF * LOG2E;  // the sentinel in log2 units
constexpr int WARPS = 4;
constexpr int NT = WARPS * 32;
constexpr int KT = 16 * WARPS;      // positions per block tile (16 a warp)
constexpr int HC = 16;              // query heads per chunk: the MMA rows
constexpr int TAB = 512;            // table entries held in shared memory
constexpr int MAX_SPLITS = 8;       // portable cluster size

template <int D>
struct Cfg {
  static constexpr int LD = D + 8;                  // padded smem row
  static constexpr int STAGES = D > 128 ? 2 : 3;    // ring depth
  // one warp's ring: STAGES x (K, V) x 16 rows
  static constexpr int RING_W = STAGES * 2 * 16 * LD;   // bf16 elements
  // a warp's partial (m[16], l[16], acc[16][D] f32) lives in its ring
  static_assert(RING_W * 2 >= (2 * 16 + 16 * D) * 4, "partial fits");
  static constexpr int SMEM =
      (HC * LD + WARPS * RING_W) * 2 + TAB * 4 + 2 * HC * 4;
};

template <int D>
__global__ void __launch_bounds__(NT, 2)
paged_decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ kpool,
                        const __nv_bfloat16* __restrict__ vpool,
                        const int* __restrict__ table,
                        const int* __restrict__ q_pos,
                        __nv_bfloat16* __restrict__ o, int KVH, int G, int d,
                        int dv, int ps, int max_pages, float scale,
                        float softcap, int window, int span) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, S = C::STAGES, CPR = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);  // [HC][LD]
  __nv_bfloat16* sRing = sQ + HC * LD;          // [WARPS][RING_W]
  int* sTab = reinterpret_cast<int*>(sRing + WARPS * C::RING_W);  // [TAB]
  float* sBm = reinterpret_cast<float*>(sTab + TAB);  // block partial m
  float* sBl = sBm + HC;                              // and l

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int split = blockIdx.x, b = blockIdx.y / KVH, h = blockIdx.y % KVH;
  const int g0 = blockIdx.z * HC, gn = min(HC, G - g0);
  // this block's span of cache positions; it walks the part of it in the
  // live window [kbeg, kend), known once q_pos is read
  const int s0 = split * span, s1 = min(max_pages * ps, s0 + span);

  // q (the chunk's heads, zero past gn rows and d columns) and the table
  // entries of the span's first window are copied asynchronously while
  // q_pos is read: one memory latency before the walk, not three
  const __nv_bfloat16* qb = q + (((size_t)b * KVH + h) * G + g0) * d;
  for (int i = tid; i < HC * CPR; i += NT) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool in = r < gn && c < d;
    cp16(sQ + r * LD + c, in ? qb + (size_t)r * d + c : qb, in);
  }
  const int* row = table + (size_t)b * max_pages;
  // window w of the span: positions s0 + w * WT * KT .. (w + 1) * WT * KT,
  // whose table entries (at most TAB) start at page p0(w)
  const int WT = max(1, ((TAB - 2) * ps) / KT);
  auto load_table = [&](int w) {
    const int p0 = (s0 + w * WT * KT) / ps;
    for (int i = tid; i < min(TAB, max_pages - p0); i += NT)
      cp4(sTab + i, row + p0 + i, true);
    cp_commit();
    return p0;
  };
  int p0 = load_table(0);
  const int qp = q_pos[b];
  const int kbeg = max(s0, window > 0 ? qp - window + 1 : 0);
  const int kend = min(s1, qp + 1);
  // the walk: span tiles a .. a + n_tiles - 1
  const int a = kbeg < kend ? (kbeg - s0) / KT : 0;
  const int n_tiles = kbeg < kend ? (kend - s0 + KT - 1) / KT - a : 0;

  __nv_bfloat16* ring = sRing + warp * C::RING_W;   // this warp's ring
  const int g = lane >> 2, t = lane & 3;
  const float sc = softcap > 0.f ? scale : scale * LOG2E;
  float m[2] = {MASKED, MASKED};     // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};           // this thread's share of l
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  cp_wait<0>();
  __syncthreads();                   // q and the first table window are in

  for (int w = a / WT; w * WT < a + n_tiles; ++w) {
    if (w > 0) {                     // a later window of a long span
      __syncthreads();               // all warps are done with the last
      p0 = load_table(w);
      cp_wait<0>();
      __syncthreads();
    }
    const int j0 = max(a, w * WT), wn = min(a + n_tiles, (w + 1) * WT) - j0;

    // gather this warp's 16 rows of tile j (window-relative): lane r < 16
    // finds row r's place in the pool once, the copies of K and then V
    // (two commit groups) take it by shuffle; rows outside [kbeg, kend)
    // and columns past d / dv are zero-filled
    auto gather = [&](int j) {
      int ridx = -1;
      const int kt = s0 + (j0 + j) * KT + warp * 16;
      if (j < wn && lane < 16) {
        const int pos = kt + lane;
        if (pos >= kbeg && pos < kend)
          ridx = (sTab[pos / ps - p0] * ps + pos % ps) * KVH + h;
      }
#pragma unroll
      for (int is_v = 0; is_v < 2; ++is_v) {
        __nv_bfloat16* dst = ring + ((j % S) * 2 + is_v) * 16 * LD;
        const __nv_bfloat16* pool = is_v ? vpool : kpool;
        const int width = is_v ? dv : d;
        if (j < wn) {
#pragma unroll
          for (int k = 0; k < 16 * CPR / 32; ++k) {
            const int i = lane + 32 * k;
            const int r = i / CPR, c = (i % CPR) * 8;
            const int ri = __shfl_sync(0xffffffffu, ridx, r);
            const bool in = ri >= 0 && c < width;
            cp16(dst + r * LD + c,
                 in ? pool + (size_t)ri * width + c : pool, in);
          }
        }
        cp_commit();
      }
    };
#pragma unroll
    for (int j = 0; j < S - 1; ++j) gather(j);

    for (int j = 0; j < wn; ++j) {
      gather(j + S - 1);
      const int kt = s0 + (j0 + j) * KT + warp * 16;  // this warp's rows
      const __nv_bfloat16* cK = ring + (j % S) * 2 * 16 * LD;
      const __nv_bfloat16* cV = cK + 16 * LD;
      cp_wait<2 * S - 1>();          // K_j has landed (V_j may not have)
      __syncwarp();
      if (kt < kend && kt + 16 > kbeg) {   // warp-uniform: a live row
        float s[2][4] = {};
        mma_abt<D, 16>(s, sQ, cK, lane);
        const bool edge = kt < kbeg || kt + 16 > kend;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[n][e] * sc;
            if (softcap > 0.f) x = tanhf(x / softcap) * softcap * LOG2E;
            const int pos = kt + n * 8 + 2 * t + (e & 1);
            if (edge && (pos < kbeg || pos >= kend)) x = MASKED;
            s[n][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        float corr[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
          mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
          corr[hh] = exp2f(m[hh] - mx[hh]);
          m[hh] = mx[hh];
          l[hh] *= corr[hh];
        }
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = exp2f(s[n][e] - m[e >> 1]);
            l[e >> 1] += p;          // the f32 p
            s[n][e] = p;             // packed to bf16 below: bf16(p)
          }
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[n][0] *= corr[0];
          acc[n][1] *= corr[0];
          acc[n][2] *= corr[1];
          acc[n][3] *= corr[1];
        }
        cp_wait<2 * S - 2>();        // V_j has landed
        __syncwarp();
        uint32_t a_op[4];
        a_from_acc(a_op, s, 0);
        mma_ab<LD, D>(acc, a_op, cV, 0, lane);
      }
      __syncwarp();                  // stage j % S is reloaded at j + S
    }
    cp_wait<0>();
    __syncwarp();
  }

  // this warp's partial, in its own ring (free now): m, l, acc[16][D]
  float* pm = reinterpret_cast<float*>(ring);
  float* pl = pm + HC;
  float* pacc = pl + HC;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    if (t == 0) {
      pm[g + 8 * hh] = m[hh];
      pl[g + 8 * hh] = l[hh];
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      *reinterpret_cast<float2*>(pacc + (g + 8 * hh) * D + n * 8 + 2 * t) =
          make_float2(acc[n][2 * hh], acc[n][2 * hh + 1]);
  __syncthreads();

  // the block's partial: the four warps' states combined, in place in
  // warp 0's acc, with m and l in sBm / sBl
  auto part = [&](int w) {
    return reinterpret_cast<float*>(sRing + w * C::RING_W);
  };
  const int half = dv / 2;           // column pairs of the output
  for (int i = tid; i < gn * half; i += NT) {
    const int r = i / half, c = 2 * (i % half);
    float mb = MASKED;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, part(w)[r]);
    float2 sum = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(part(w)[r] - mb);
      const float2 x =
          *reinterpret_cast<const float2*>(part(w) + 2 * HC + r * D + c);
      sum.x += x.x * wt;
      sum.y += x.y * wt;
    }
    *reinterpret_cast<float2*>(part(0) + 2 * HC + r * D + c) = sum;
  }
  if (tid < gn) {
    float mb = MASKED, lb = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mb = fmaxf(mb, part(w)[tid]);
#pragma unroll
    for (int w = 0; w < WARPS; ++w)
      lb += part(w)[HC + tid] * exp2f(part(w)[tid] - mb);
    sBm[tid] = mb;
    sBl[tid] = lb;
  }

  // the splits' partials, summed over the cluster: block r finishes slice
  // r of the chunk's output
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();
  const int n_split = gridDim.x, rank = (int)cl.block_rank();
  const int total = gn * half, per = (total + n_split - 1) / n_split;
  const int e_end = min(total, (rank + 1) * per);
  __nv_bfloat16* ob = o + (((size_t)b * KVH + h) * G + g0) * dv;
  for (int i = rank * per + tid; i < e_end; i += NT) {
    const int r = i / half, c = 2 * (i % half);
    float mt = MASKED;
    for (int k = 0; k < n_split; ++k)
      mt = fmaxf(mt, cl.map_shared_rank(sBm, k)[r]);
    float lt = 0.f;
    float2 sum = make_float2(0.f, 0.f);
    for (int k = 0; k < n_split; ++k) {
      const float wt = exp2f(cl.map_shared_rank(sBm, k)[r] - mt);
      lt += cl.map_shared_rank(sBl, k)[r] * wt;
      const float2 x = *reinterpret_cast<const float2*>(
          cl.map_shared_rank(part(0), k) + 2 * HC + r * D + c);
      sum.x += x.x * wt;
      sum.y += x.y * wt;
    }
    const float l_safe = fmaxf(lt, 1e-30f);
    *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * dv + c) =
        __floats2bfloat162_rn(sum.x / l_safe, sum.y / l_safe);
  }
  cl.sync();                         // keep every partial until it is read
}

template <int D>
int launch(const void* q, const void* kpool, const void* vpool,
           const void* table, const void* q_pos, void* o, int B, int KVH,
           int G, int d, int dv, int ps, int max_pages, float scale,
           float softcap, int window, int n_split, int span,
           cudaStream_t stream) {
  using C = Cfg<D>;
  auto kernel = paged_decode_mma_kernel<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, B * KVH, (G + HC - 1) / HC);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_split;     // the splits of one chunk
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kpool),
      static_cast<const __nv_bfloat16*>(vpool),
      static_cast<const int*>(table), static_cast<const int*>(q_pos),
      static_cast<__nv_bfloat16*>(o), KVH, G, d, dv, ps, max_pages, scale,
      softcap, window, span);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, KVH, G, d) bf16; pools: (P, page_size, KVH, d / dv) bf16;
// table: (B, max_pages) int32; q_pos: (B,) int32; o: (B, KVH, G, dv) bf16.
// All contiguous and 16-byte aligned; d, dv <= 256 and % 8 == 0; any G.
// n_split (1..8) blocks of one (slot, KV head, chunk) each walk `span`
// positions (a multiple of 64; n_split x span >= max_pages x page_size),
// as kernels/flash_attention.py:paged_plan chooses them.
extern "C" int paged_decode_attention(const void* q, const void* kpool,
                                      const void* vpool, const void* table,
                                      const void* q_pos, void* o, int B,
                                      int KVH, int G, int d, int dv,
                                      int page_size, int max_pages,
                                      float scale, float softcap, int window,
                                      int n_split, int span, void* stream) {
  if (n_split < 1 || n_split > MAX_SPLITS || span < KT || span % KT != 0 ||
      (long long)n_split * span < (long long)max_pages * page_size ||
      d % 8 != 0 || dv % 8 != 0 || page_size < 1)
    return (int)cudaErrorInvalidValue;
  const int w = d > dv ? d : dv;
  auto fn = w <= 64 ? launch<64> : w <= 128 ? launch<128>
            : w <= 256 ? launch<256> : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(q, kpool, vpool, table, q_pos, o, B, KVH, G, d, dv, page_size,
            max_pages, scale, softcap, window, n_split, span,
            static_cast<cudaStream_t>(stream));
}

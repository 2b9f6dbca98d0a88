// Gene statistics of jepeg / jepegmix: the per-population partials of a
// bucket of gathered gene blocks, and the float64 combine, ridge and W
// contractions that turn them into each gene's category statistics.
//
// No Pallas kernel corresponds to these.  On the TPU the work is one jitted
// XLA program, gauss_tpu/core/genekernels.py:222 (_gene_stats_unsharded,
// body :179-219, the combine _corr_from_pop_partials :136-176): K2's gather,
// per-population f32 Grams, a float64 CalWgtCov combine, the 1 + lambda
// ridge and the contractions with W.  Two entry points replace it
// (ops/gene_stats.py holds the wrappers and, beside each, the torch code it
// replaced as its plain version):
//
//   gauss_gene_partials  C [P, B, n, n], S [P, B, n], Q [P, B, n]: for the
//                        int8 gene blocks X [B, n, S] and each segment k of
//                        columns [lo_k, hi_k), C = X_k X_k^T, S and Q the
//                        row sums of X_k and X_k^2, exact integers in f32;
//   gauss_gene_tail      from those partials, per gene, either the
//                        correlation CorG [B, n, n] float64 (corr mode) or
//                        CovU = W R W^T, WWt = W W^T [B, 6, 6] and U = W z
//                        [B, 6] float64 (stats mode), R being CorG with the
//                        pairs of pad rows zeroed and the diagonal replaced
//                        by 1 + lambda (src/gene.cpp:569-648).
//
// What bounds them on this card.  The partials read the gathered block
// once (jepegmix at 33,168 subject columns: ~3,700 gene rows, ~130 MB a
// call) and do B n^2 S / 2 int8 multiply-adds (~2 GOP): bytes, ~0.04 ms at
// 3.35 TB/s, with the tensor cores ~100x ahead.  dp4a on CUDA cores, each
// fed by two shared-memory word loads, took more time than the bytes.  The
// tail reads a few MB; its float64 chains over the P populations are
// short, so a launch lasts as long as one block's path: its loads, then
// its chains, then its contractions.
//
// What the design does about it:
//  * gene_partials: mma.sync m16n8k32 s8 (IMMA) fed straight from
//    registers.  Since C = X X^T, a thread's A fragment for rows g, g + 8
//    of a 16-row tile is its B fragment for the 8-row tiles of those rows:
//    each thread loads aligned 16-byte pieces of its rows (4 pieces a row
//    in flight at n <= 16, 2 above), bytes outside the segment masked in
//    registers (segments are not padded: a piece may straddle two
//    populations), and the four threads of a group cover 64 contiguous
//    bytes a row, two k-steps of 32.  The sum over k is order-free, so any
//    byte order shared by A and B gives the same C.  No shared memory and
//    no barrier in the main loop.  A block takes one gene (and 32 x 32
//    tile of C's lower triangle; n = 8 and 16 take one 8 x 8 or 16 x 16
//    tile, at n = 8 with A's rows 8-15 zero) and a group of consecutive
//    segments chosen on the host: populations of 64 to 6,360 columns would
//    leave most warps of a one-segment block idle.  Its warps deal the
//    group's 256-byte steps among them; each adds its exact int32 sums of
//    a segment into shared memory when it moves past it, and the block
//    writes each segment's C, S, Q once.  S is dp4a against ones on the
//    same registers, Q is C's diagonal.  An off-diagonal tile writes its
//    transpose too (both halves are the same exact integers).
//  * gene_tail: one block per G genes (n <= 64: G n^2 pairs, 256 at
//    n <= 16) or per (gene, 64 x 64 tile of pairs) at n >= 128.  One
//    thread asks for each array's populations in a single 3-D TMA box
//    (C's genes or tile, S and Q of its rows): 16-byte copies by every
//    thread were held back by the SM's outstanding requests, and bulk
//    copies a row apart go out one lane at a time.  Populations that do
//    not fit come in rounds.  All threads then
//    widen each (row, population)'s S and Q once and form s / m_k,
//    w_k s / m_k and the rows' terms; each pair's and row's float64 chain
//    (the rows' on a warp of their own at n <= 16, beside the pairs')
//    adds its terms in the plain version's population order, each step
//    one correctly rounded operation (__dadd_rn and friends keep nvcc
//    from contracting them into FMAs), so CorG equals the plain version's
//    bit for bit; s / m_k is s * (1 / m_k), the reciprocal taken on the
//    host, as PyTorch's CUDA division by a Python scalar computes it.  In
//    stats mode R goes to shared memory and W R W^T, W W^T and W z are
//    summed over (q, l) and columns or row slices in a fixed order; a
//    gene of several tiles writes each tile's 36 partial sums to scratch
//    and its last tile (a ticket) adds them in tile order.

#include <cstdint>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxPops = 64;             // segments / populations per call

// ---------------------------------------------------------------- partials

constexpr int kPartialsMaxWarps = 8;

// The segments, and the groups of consecutive segments a block takes:
// group g holds segments [group[g], group[g + 1]).
struct Segments {
  int lo[kMaxPops];
  int hi[kMaxPops];
  int group[kMaxPops + 1];
};

// C tile side TI (8, 16 or 32) -> a thread's share of it
template <int TI>
struct PTile {
  static constexpr int kR = TI / 8;                 // rows held a side
  static constexpr int kAT = TI < 16 ? 1 : TI / 16; // A's 16-row tiles
  static constexpr int kBT = TI / 8;                // B's 8-row tiles
  static constexpr int kU = TI <= 16 ? 4 : 2;       // pieces a row in flight
  static constexpr int kChunk = 64 * kU;            // bytes a row a step
  static constexpr int kSegs = TI <= 16 ? 16 : 8;   // segments a group
};

// the 16 bytes of ``row`` at column ``col`` (16-aligned), those outside
// [lo, hi) zeroed; columns at or past ``end`` read as zeros
__device__ __forceinline__ void load_piece(const int8_t* row, int64_t col,
                                           int lo, int hi, int64_t end,
                                           uint32_t w[4]) {
  if (col >= end) {
    w[0] = w[1] = w[2] = w[3] = 0u;
    return;
  }
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + col));
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
  if (col >= lo && col + 16 <= hi) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t keep = 0u;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int64_t c = col + 4 * e + q;
      if (c >= lo && c < hi) keep |= 0xFFu << (8 * q);
    }
    w[e] &= keep;
  }
}

// d += A[16 x 32] B[32 x 8], int8 in, exact int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// [a0, a1): a segment's columns from its first 16-byte piece to its last
__device__ __forceinline__ int64_t seg_a0(const Segments& seg, int k) {
  return seg.lo[k] & ~15;
}
__device__ __forceinline__ int64_t seg_a1(const Segments& seg, int k,
                                          int64_t S) {
  const int64_t a1 = (static_cast<int64_t>(seg.hi[k]) + 15) & ~int64_t{15};
  return a1 < S ? a1 : S;
}

// A warp's sums of one step (columns [c, c + kChunk) of segment [lo, hi),
// none past end): acc[a][j] += the m16n8 product of A tile a (the I side's
// rows 16 a + g and + 8) with B tile j (the J side's rows 8 j + g), g =
// lane / 4; rs += the row sums of the thread's I-side rows (diagonal
// tiles).  x and y point at the thread's first I- and J-side rows; its
// rows are 8 apart.
template <int TI, bool kDiag>
__device__ __forceinline__ void partials_step(
    const int8_t* x, const int8_t* y, int64_t S, int64_t c, int64_t end,
    int lo, int hi, int (&acc)[PTile<TI>::kAT][PTile<TI>::kBT][4],
    int (&rs)[PTile<TI>::kR]) {
  using T = PTile<TI>;
  const int t16 = 16 * (threadIdx.x & 3);
  uint32_t xw[T::kR][T::kU][4];
  uint32_t yw[kDiag ? 1 : T::kR][T::kU][4];
#pragma unroll
  for (int s = 0; s < T::kR; ++s)
#pragma unroll
    for (int u = 0; u < T::kU; ++u) {
      const int64_t col = c + 64 * u + t16;
      load_piece(x + 8 * s * S, col, lo, hi, end, xw[s][u]);
      if constexpr (!kDiag)
        load_piece(y + 8 * s * S, col, lo, hi, end, yw[s][u]);
    }
#pragma unroll
  for (int u = 0; u < T::kU; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h)           // words 2h, 2h + 1: one k-step
#pragma unroll
      for (int a = 0; a < T::kAT; ++a) {
        const int s0 = TI < 16 ? 0 : 2 * a;
        const uint32_t a0 = xw[s0][u][2 * h], a2 = xw[s0][u][2 * h + 1];
        uint32_t a1 = 0u, a3 = 0u;        // rows 8-15 of A: none at n = 8
        if constexpr (TI >= 16) {
          a1 = xw[s0 + 1][u][2 * h];
          a3 = xw[s0 + 1][u][2 * h + 1];
        }
#pragma unroll
        for (int j = 0; j < T::kBT; ++j) {
          if constexpr (kDiag)
            mma_s8(acc[a][j], a0, a1, a2, a3, xw[j][u][2 * h],
                   xw[j][u][2 * h + 1]);
          else
            mma_s8(acc[a][j], a0, a1, a2, a3, yw[j][u][2 * h],
                   yw[j][u][2 * h + 1]);
        }
      }
  if constexpr (kDiag) {
#pragma unroll
    for (int s = 0; s < T::kR; ++s)
#pragma unroll
      for (int u = 0; u < T::kU; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rs[s] = __dp4a(static_cast<int>(xw[s][u][e]), 0x01010101, rs[s]);
  }
}

// Adds a warp's sums of one segment into the block's (red: the tile, rsum:
// the I side's row sums), and clears them.
template <int TI>
__device__ __forceinline__ void partials_flush(
    int (&acc)[PTile<TI>::kAT][PTile<TI>::kBT][4], int (&rs)[PTile<TI>::kR],
    int* red, int* rsum) {
  using T = PTile<TI>;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int a = 0; a < T::kAT; ++a)
#pragma unroll
    for (int j = 0; j < T::kBT; ++j) {
      const int r0 = 16 * a + g, c = 8 * j + 2 * t;
      atomicAdd(&red[r0 * TI + c], acc[a][j][0]);
      atomicAdd(&red[r0 * TI + c + 1], acc[a][j][1]);
      if (TI >= 16) {
        atomicAdd(&red[(r0 + 8) * TI + c], acc[a][j][2]);
        atomicAdd(&red[(r0 + 8) * TI + c + 1], acc[a][j][3]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][j][r] = 0;
    }
#pragma unroll
  for (int s = 0; s < T::kR; ++s) {
    rs[s] += __shfl_xor_sync(0xffffffffu, rs[s], 1);
    rs[s] += __shfl_xor_sync(0xffffffffu, rs[s], 2);
    if (t == 0) atomicAdd(&rsum[g + 8 * s], rs[s]);
    rs[s] = 0;
  }
}

// The block's group of segments, its steps dealt to its warps in turn
// (warp w: steps w, w + nw, .. of the group's steps, segment after
// segment), each warp adding its sums of a segment into red / rsum when
// it moves past it.
template <int TI, bool kDiag>
__device__ __forceinline__ void partials_group(
    const Segments& seg, int k0, int k1, const int8_t* x, const int8_t* y,
    int64_t S, int* red, int* rsum) {
  using T = PTile<TI>;
  int acc[T::kAT][T::kBT][4];
#pragma unroll
  for (int a = 0; a < T::kAT; ++a)
#pragma unroll
    for (int j = 0; j < T::kBT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[a][j][r] = 0;
  int rs[T::kR];
#pragma unroll
  for (int s = 0; s < T::kR; ++s) rs[s] = 0;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int k = k0;
  int64_t first = 0;                       // the group's step of k's first
  int64_t steps = (seg_a1(seg, k, S) - seg_a0(seg, k) + T::kChunk - 1) /
                  T::kChunk;
  bool dirty = false;
  for (int64_t f = warp;; f += nw) {
    while (k < k1 && f >= first + steps) {
      if (dirty) {
        partials_flush<TI>(acc, rs, red + (k - k0) * TI * TI,
                           rsum + (k - k0) * TI);
        dirty = false;
      }
      first += steps;
      if (++k < k1)
        steps = (seg_a1(seg, k, S) - seg_a0(seg, k) + T::kChunk - 1) /
                T::kChunk;
    }
    if (k >= k1) break;
    partials_step<TI, kDiag>(x, y, S, seg_a0(seg, k) + (f - first) * T::kChunk,
                             seg_a1(seg, k, S), seg.lo[k], seg.hi[k], acc, rs);
    dirty = true;
  }
}

template <int TI>
__global__ void __launch_bounds__(32 * kPartialsMaxWarps)
gene_partials_kernel(const int8_t* __restrict__ X, int64_t S, int B, int n,
                     int tiles, Segments seg, float* __restrict__ C,
                     float* __restrict__ Ssum, float* __restrict__ Q) {
  using T = PTile<TI>;
  __shared__ int red[T::kSegs * TI * TI];
  __shared__ int rsum[T::kSegs * TI];
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  int I = 0;                                // lower-triangle tile (I >= J)
  while ((I + 1) * (I + 2) / 2 <= tile) ++I;
  const int J = tile - I * (I + 1) / 2;
  const bool diag = I == J;
  const int k0 = seg.group[blockIdx.y], k1 = seg.group[blockIdx.y + 1];
  const int ns = k1 - k0;
  for (int e = threadIdx.x; e < ns * TI * TI; e += blockDim.x) red[e] = 0;
  for (int e = threadIdx.x; e < ns * TI; e += blockDim.x) rsum[e] = 0;
  __syncthreads();

  const int g = (threadIdx.x & 31) >> 2;
  const int8_t* x = X + (static_cast<int64_t>(b) * n + I * TI + g) * S;
  const int8_t* y = X + (static_cast<int64_t>(b) * n + J * TI + g) * S;
  if (diag)
    partials_group<TI, true>(seg, k0, k1, x, x, S, red, rsum);
  else
    partials_group<TI, false>(seg, k0, k1, x, y, S, red, rsum);
  __syncthreads();

  // each segment's exact sums, written once
  for (int e = threadIdx.x; e < ns * TI * TI; e += blockDim.x) {
    const int ks = e / (TI * TI), ij = e - ks * TI * TI;
    const int i = ij / TI, j = ij - (ij / TI) * TI;
    const int64_t pb = static_cast<int64_t>(k0 + ks) * B + b;
    const int gi = I * TI + i, gj = J * TI + j;
    const float f = static_cast<float>(red[e]);
    C[(pb * n + gi) * n + gj] = f;
    if (!diag) C[(pb * n + gj) * n + gi] = f;
    else if (i == j) Q[pb * n + gi] = f;
  }
  if (diag) {
    for (int e = threadIdx.x; e < ns * TI; e += blockDim.x) {
      const int ks = e / TI, r = e - ks * TI;
      const int64_t pb = static_cast<int64_t>(k0 + ks) * B + b;
      Ssum[pb * n + I * TI + r] = static_cast<float>(rsum[e]);
    }
  }
}

template <int TI>
cudaError_t launch_partials(const int8_t* X, int64_t S, int B, int n,
                            int groups, const Segments& seg, int nw, float* C,
                            float* Ssum, float* Q, cudaStream_t st) {
  for (int g = 0; g < groups; ++g)
    if (seg.group[g + 1] - seg.group[g] > PTile<TI>::kSegs)
      return cudaErrorInvalidValue;
  const int nt = n / TI;
  const int tiles = nt * (nt + 1) / 2;
  const dim3 grid(static_cast<unsigned>(B) * tiles, groups);
  gene_partials_kernel<TI><<<grid, 32 * nw, 0, st>>>(X, S, B, n, tiles, seg,
                                                     C, Ssum, Q);
  return cudaGetLastError();
}

// -------------------------------------------------------------------- tail

constexpr int kThreads = 256;
constexpr int kPairTile = 64;            // gene_tail's tile side, at most
constexpr int kMaxSmem = 200 * 1024;     // dynamic shared memory, at most
constexpr int kMaxRows = 2 * kPairTile;  // a block's rows (and columns)

struct TailArgs {
  const float* C;                 // [P, B, n, n]
  const float* S;                 // [P, B, n]
  const float* Q;                 // [P, B, n]
  const int32_t* ids;             // [B n] panel rows, < 0 on pad rows
  const double* Wz;               // [B n, 7]: W^T, then z
  double* out0;                   // CovU [B, 36] (stats) or CorG [B, n, n]
  double* out1;                   // WWt [B, 36]
  double* out2;                   // U [B, 6]
  double* scratch;                // [B, tiles, 36] tile partials of CovU
  int* tickets;                   // [B] tiles finished, zeroed per launch
  int P, B, n, pooled;
  // the layout (tail_layout): tile side, tiles a gene side, genes a
  // block (1 when nt > 1), rows a block takes (G ts, or 2 ts: the tile's
  // rows then its columns), populations a round, C's chunk (the inner box
  // of its tensor map), and the byte offsets in shared memory of a
  // round's S, Q and row values (after its C) and of the W z rows and ids
  int ts, nt, genes, rows, stages, chunk;
  int s_off, q_off, v_off, w_off, ids_off;
  double npool;                   // pooled: sum of the true sizes
  double ridge;                   // 1 + lambda
  // weighted: by population w_k m_k / (m_k - 1), m_k (the true sizes),
  // w_k and 1 / m_k
  double cst[4][kMaxPops];
};

constexpr int kRowVals = 5;       // sd, sm, ws and the rows' two terms

// One launch's layout from n, P, the mode and the caller's choice of
// genes a block and populations a round (ops/gene_stats.py: tail_layout);
// false when they do not fit.  Shared memory: a round's C [stages][G ts
// ts] (a tile: [stages][ts][ts]), S and Q [stages][rows] (a tile: its
// rows' [stages][ts], then its columns'), the row values [5][stages]
// [rows] doubles; in stats mode the epilogue's R, W R and slices reuse
// them; then the W z rows and ids.
bool tail_layout(TailArgs& a, int stats, int genes, int stages, int* smem) {
  const int n = a.n;
  a.ts = n < kPairTile ? n : kPairTile;
  a.nt = n / a.ts;
  a.genes = genes;
  a.rows = a.nt == 1 ? genes * a.ts : 2 * a.ts;
  a.chunk = a.nt == 1 ? (n * n < 256 ? n * n : 256) : a.ts;
  const int pairs = genes * a.ts * a.ts;
  if (genes < 1 || (a.nt > 1 && genes > 1) || pairs > 16 * kThreads ||
      a.rows > kMaxRows || stages < 1 || stages > a.P ||
      (a.nt == 1 && (genes * n * n) % a.chunk))
    return false;
  a.stages = stages;
  auto up = [](int x) { return (x + 127) & ~127; };
  a.s_off = up(4 * stages * pairs);
  a.q_off = a.s_off + up(4 * stages * a.rows);
  a.v_off = a.q_off + up(4 * stages * a.rows);
  int end = a.v_off + 8 * kRowVals * stages * a.rows;
  // the stats epilogue reuses a round's arrays: R, W R, the W W^T / W z
  // slices
  const int epi = stats ? 8 * (pairs + genes * 6 * a.ts + kThreads) : 0;
  if (end < epi) end = epi;
  a.w_off = up(end);
  a.ids_off = a.w_off + (stats ? up(8 * 7 * a.rows) : 0);
  *smem = a.ids_off + (stats ? 4 * a.rows : 0) + 128;   // + the alignment
  return *smem <= kMaxSmem;
}

// A 3-D tensor map of float32 [d2][d1][d0] (strides s1, s2 in bytes, d0
// contiguous), boxes of b0 x b1 x b2, zero fill out of bounds.
bool encode_box3(CUtensorMap* map, const void* base, long long d0,
                 long long d1, long long d2, long long s1, long long s2,
                 int b0, int b1, int b2) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  cuuint64_t strides[2] = {(cuuint64_t)s1, (cuuint64_t)s2};
  cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, (cuuint32_t)b2};
  cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// W W^T and W z of a block's genes from their n rows of W z (``wz``,
// shared or global memory, gene after gene): 42 outputs a gene, each
// summed over ``slices`` row slices (ww_part, item z of gb 42 slices into
// part[z]), then the slices in order (ww_sum, item z of gb 42).
__device__ __forceinline__ void ww_part(const TailArgs& a, const double* wz,
                                        int slices, int z, double* part) {
  const int n = a.n, len = (n + slices - 1) / slices;
  const int g = z / (42 * slices), o = (z / slices) % 42, h = z % slices;
  const int q = o < 36 ? o / 6 : o - 36, l = o < 36 ? o % 6 : 6;
  const double* w = wz + static_cast<int64_t>(g) * n * 7;
  const int end = (h + 1) * len < n ? (h + 1) * len : n;
  double s = 0.0;
  for (int r = h * len; r < end; ++r) s = fma(w[r * 7 + q], w[r * 7 + l], s);
  part[z] = s;
}

__device__ __forceinline__ void ww_sum(const TailArgs& a, int b0, int slices,
                                       int z, const double* part) {
  const int g = z / 42, o = z % 42;
  double s = 0.0;
  for (int h = 0; h < slices; ++h) s += part[z * slices + h];
  const int64_t gene = b0 + g;
  if (o < 36) a.out1[gene * 36 + o] = s;
  else a.out2[gene * 6 + o - 36] = s;
}

// The tensor maps of C, S and Q (tail_maps).
struct TailMaps {
  CUtensorMap C, S, Q;
};

// A block's threads: kThreads for the pairs, and at one pair a thread
// (n <= 16: at most 32 rows) one more warp for the rows' chains, which
// then run beside the pairs' instead of before them on warp 0.
template <int kPP>
__host__ __device__ constexpr int tail_block() {
  return kThreads + (kPP == 1 ? 32 : 0);
}

template <bool kStats, int kPP>
__global__ void __launch_bounds__(tail_block<kPP>(), kPP == 1 ? 2 : 1)
gene_tail_kernel(const __grid_constant__ TailMaps maps, TailArgs a) {
  constexpr int kBlock = tail_block<kPP>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ double sd_s[kMaxRows], m_s[kMaxRows];
  __shared__ double cst[4][kMaxPops];    // wf, m, w, 1 / m by population
  __shared__ __align__(8) uint64_t full, wbar;
  __shared__ int last;
  // the boxes land 128-byte aligned
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  const int n = a.n, ts = a.ts, P = a.P, NS = a.stages, R = a.rows;
  const int t = threadIdx.x;
  int b0, gb, I = 0, J = 0, tile = 0;
  if (a.nt == 1) {
    b0 = blockIdx.x * a.genes;
    gb = a.B - b0 < a.genes ? a.B - b0 : a.genes;
  } else {
    const int tiles = a.nt * a.nt;
    b0 = blockIdx.x / tiles;
    gb = 1;
    tile = blockIdx.x - b0 * tiles;
    I = tile / a.nt;
    J = tile - I * a.nt;
  }
  const float* Cr = reinterpret_cast<const float*>(smem);
  const float* Sr = reinterpret_cast<const float*>(smem + a.s_off);
  const float* Qr = reinterpret_cast<const float*>(smem + a.q_off);
  double* rv = reinterpret_cast<double*>(smem + a.v_off);   // [5][NS][R]
  double* Ws = reinterpret_cast<double*>(smem + a.w_off);
  int* idss = reinterpret_cast<int*>(smem + a.ids_off);
  const int pairs_g = a.genes * ts * ts;   // C's floats a population
  // a round's bytes: its boxes, out-of-bounds parts (past the last gene
  // or population) zero-filled and counted
  const int round_bytes = 4 * NS * (pairs_g + 2 * R);

  // one round of populations [k0, k0 + NS): one box each of C, S and Q
  // (a tile: C, then S and Q of its rows and of its columns)
  auto request = [&](int k0) {
    mbar_expect_tx(&full, round_bytes);
    if (a.nt == 1) {
      tma_load_3d(smem, &maps.C, &full, 0, b0 * n * n / a.chunk, k0);
      tma_load_3d(smem + a.s_off, &maps.S, &full, 0, b0, k0);
      tma_load_3d(smem + a.q_off, &maps.Q, &full, 0, b0, k0);
    } else {
      tma_load_3d(smem, &maps.C, &full, J * ts, b0 * n + I * ts, k0);
      for (int side = 0; side < 2; ++side) {
        const int c = (side ? J : I) * ts;
        tma_load_3d(smem + a.s_off + 4 * side * NS * ts, &maps.S, &full, c,
                      b0, k0);
        tma_load_3d(smem + a.q_off + 4 * side * NS * ts, &maps.Q, &full, c,
                      b0, k0);
      }
    }
  };
  if (t == 0) {
    mbar_init(&full, 1);
    mbar_init(&wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    request(0);
    if (kStats) {                        // the W z rows and ids
      const int side_rows = a.nt == 1 ? gb * n : ts;
      const int sides = a.nt == 1 ? 1 : 2;
      mbar_expect_tx(&wbar, sides * side_rows * 60);
      for (int side = 0; side < sides; ++side) {
        const int64_t r = static_cast<int64_t>(b0) * n + (side ? J : I) * ts;
        bulk_load(Ws + side * ts * 7, a.Wz + r * 7, 56 * side_rows, &wbar);
        bulk_load(idss + side * ts, a.ids + r, 4 * side_rows, &wbar);
      }
    }
  }
  // the weighted combine's constants, read every step, in shared memory
  // (a kernel parameter at a varying index costs a constant-cache miss)
  if (!a.pooled && t < P) {
#pragma unroll
    for (int w = 0; w < 4; ++w) cst[w][t] = a.cst[w][t];
  }
  __syncthreads();                       // the barriers and constants set

  // this thread's pairs: e, its C offset in a population; ri, cj: the
  // rows of its row and column among the block's R
  const int npairs = gb * ts * ts;
  const int nrows = a.nt == 1 ? gb * ts : 2 * ts;
  const bool pt = t < kThreads;          // a pair thread
  const int rt = kBlock > kThreads ? t - kThreads : t;   // its row, if any
  const bool row = rt >= 0 && rt < nrows;
  int ce[kPP], ri[kPP], cj[kPP];
#pragma unroll
  for (int u = 0; u < kPP; ++u) {
    const int e = t + u * kThreads;
    const int g = e / (ts * ts), i = (e / ts) % ts, j = e % ts;
    ce[u] = e;
    ri[u] = g * ts + i;
    cj[u] = a.nt == 1 ? g * ts + j : ts + j;
  }
  double p0[kPP], p1[kPP];                // cov, mimj (pooled: c0)
#pragma unroll
  for (int u = 0; u < kPP; ++u) p0[u] = p1[u] = 0.0;
  double r0 = 0.0, r1 = 0.0, r2 = 0.0;    // mi, var, vmimj (pooled: s, q)

  for (int k0 = 0, round = 0; k0 < P; k0 += NS, ++round) {
    const int nk = P - k0 < NS ? P - k0 : NS;
    if (k0 > 0) {
      __syncthreads();                   // the last round's readers are done
      if (t == 0) request(k0);
    }
    mbar_wait(&full, round & 1);
    // each (population, row)'s values, once: S and Q widened, s / m_k,
    // w_k s / m_k and the rows' two terms (pooled: S and Q widened)
    for (int x = t; x < nk * nrows; x += kBlock) {
      const int kk = x / nrows, r = x - kk * nrows;
      // S's box: [NS][R] (a tile: its rows' [NS][ts], then its columns')
      const int o = a.nt == 1 ? kk * R + r
                              : (r < ts ? 0 : NS * ts - ts) + kk * ts + r;
      const double sv = static_cast<double>(Sr[o]);
      const double qv = static_cast<double>(Qr[o]);
      double* v = rv + kk * R + r;
      v[0] = sv;
      if (a.pooled) {
        v[3 * NS * R] = qv;
        continue;
      }
      const int k = k0 + kk;
      const double sm = __dmul_rn(sv, cst[3][k]);
      const double ws = __dmul_rn(cst[2][k], sm);
      v[NS * R] = sm;
      v[2 * NS * R] = ws;
      v[3 * NS * R] = __dmul_rn(cst[0][k], __dsub_rn(__dmul_rn(cst[1][k], qv),
                                                     __dmul_rn(sv, sv)));
      v[4 * NS * R] = __dmul_rn(ws, sm);
    }
    __syncthreads();
    // the chains, population after population
    if (row) {
      const double* v = rv + rt;
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk, v += R) {
        if (a.pooled) {
          r0 = __dadd_rn(r0, v[0]);
          r1 = __dadd_rn(r1, v[3 * NS * R]);
        } else {
          r0 = __dadd_rn(r0, v[2 * NS * R]);
          r1 = __dadd_rn(r1, v[3 * NS * R]);
          r2 = __dadd_rn(r2, v[4 * NS * R]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kPP; ++u) {
      if (!pt || t + u * kThreads >= npairs) continue;
      const float* c = Cr + ce[u];
      if (a.pooled) {
        for (int kk = 0; kk < nk; ++kk, c += pairs_g)
          p0[u] = __dadd_rn(p0[u], static_cast<double>(*c));
        continue;
      }
      const double* vi = rv + ri[u];
      const double* vj = rv + cj[u];
#pragma unroll 4
      for (int kk = 0; kk < nk; ++kk, c += pairs_g, vi += R, vj += R) {
        const int k = k0 + kk;
        p0[u] = __dadd_rn(p0[u], __dmul_rn(cst[0][k], __dsub_rn(
                    __dmul_rn(cst[1][k], static_cast<double>(*c)),
                    __dmul_rn(vi[0], vj[0]))));
        p1[u] = __dadd_rn(p1[u], __dmul_rn(vi[2 * NS * R], vj[NS * R]));
      }
    }
  }

  // each row's (std, mean), then each pair's correlation
  if (row) {
    if (a.pooled) {
      sd_s[rt] = __dsqrt_rn(__dsub_rn(__dmul_rn(a.npool, r1),
                                      __dmul_rn(r0, r0)));
    } else {
      sd_s[rt] = __dsqrt_rn(__dsub_rn(__dadd_rn(r1, r2), __dmul_rn(r0, r0)));
    }
    m_s[rt] = r0;
  }
  __syncthreads();                       // rows done; the round's arrays free
  double* Rs = reinterpret_cast<double*>(smem);
  if (kStats) mbar_wait(&wbar, 0);
#pragma unroll
  for (int u = 0; u < kPP; ++u) {
    const int e = t + u * kThreads;
    if (!pt || e >= npairs) continue;
    const double sdi = sd_s[ri[u]], sdj = sd_s[cj[u]];
    const double mi = m_s[ri[u]], mj = m_s[cj[u]];
    double Rv;
    if (a.pooled) {
      Rv = __ddiv_rn(__dsub_rn(__dmul_rn(a.npool, p0[u]), __dmul_rn(mi, mj)),
                     __dmul_rn(sdi, sdj));
    } else {
      const double cov = __dsub_rn(__dadd_rn(p0[u], p1[u]), __dmul_rn(mi, mj));
      Rv = __ddiv_rn(cov, __dmul_rn(sdi, sdj));
    }
    const int i = (e / ts) % ts, j = e % ts;
    if (!kStats) {
      if (a.nt == 1)
        a.out0[static_cast<int64_t>(b0) * n * n + e] = Rv;
      else
        a.out0[(static_cast<int64_t>(b0) * n + I * ts + i) * n + J * ts + j] =
            Rv;
      continue;
    }
    // pad pairs are zero (a select: a pad row's NaN must not survive);
    // CorG (1 - eye) + (1 + lambda) eye: a real NaN diagonal stays NaN
    if (!(idss[ri[u]] >= 0 && idss[cj[u]] >= 0)) Rv = 0.0;
    Rv = I == J && i == j
             ? __dadd_rn(__dmul_rn(Rv, 0.0), __dmul_rn(a.ridge, 1.0))
             : __dadd_rn(__dmul_rn(Rv, 1.0), __dmul_rn(a.ridge, 0.0));
    Rs[e] = Rv;
  }
  if (!kStats) return;
  __syncthreads();

  // (W R)[g][q][j] over the tile's rows i, then the tile's W R W^T; W W^T
  // and W z (a gene of one tile) beside them, in the same loops
  double* WR = Rs + npairs;
  double* part = WR + gb * 6 * ts;
  const int nwr = gb * 6 * ts;
  const int slices = a.nt == 1 ? kThreads / (42 * gb) : 0;
  for (int x = t; x < nwr + gb * 42 * slices; x += kBlock) {
    if (x >= nwr) {
      ww_part(a, Ws, slices, x - nwr, part);
      continue;
    }
    const int g = x / (6 * ts), q = (x / ts) % 6, j = x % ts;
    const double* w = Ws + g * ts * 7 + q;
    const double* r = Rs + g * ts * ts + j;
    double s = 0.0;
    for (int i = 0; i < ts; ++i) s = fma(w[i * 7], r[i * ts], s);
    WR[x] = s;
  }
  __syncthreads();
  double tv = 0.0;
  const int cw = a.nt == 1 ? 0 : ts;     // the staged rows of the columns
  for (int y = t; y < gb * 36 + (slices ? gb * 42 : 0); y += kBlock) {
    if (y >= gb * 36) {
      ww_sum(a, b0, slices, y - gb * 36, part);
      continue;
    }
    const int g = y / 36, q = (y % 36) / 6, l = y % 6;
    const double* wr = WR + (g * 6 + q) * ts;
    const double* w = Ws + (cw + g * ts) * 7 + l;
    double s = 0.0;
    for (int j = 0; j < ts; ++j) s = fma(wr[j], w[j * 7], s);
    if (a.nt == 1) a.out0[(static_cast<int64_t>(b0) + g) * 36 + q * 6 + l] = s;
    else tv = s;
  }
  if (a.nt == 1) return;

  // a gene of several tiles: its last tile adds their sums in tile order
  const int tiles = a.nt * a.nt;
  const int64_t b = b0;
  if (t < 36) a.scratch[(b * tiles + tile) * 36 + t] = tv;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(&a.tickets[b], 1) == tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (t < 36) {
    tv = 0.0;
    for (int h = 0; h < tiles; ++h)
      tv += __ldcg(&a.scratch[(b * tiles + h) * 36 + t]);
    a.out0[b * 36 + t] = tv;
  }
  if (t == 0) a.tickets[b] = 0;
  const int sl = kThreads / 42;
  const double* wz = a.Wz + b * n * 7;
  for (int z = t; z < 42 * sl; z += kBlock) ww_part(a, wz, sl, z, part);
  __syncthreads();
  if (t < 42) ww_sum(a, b0, sl, t, part);
}

// C as [P][B n n / chunk][chunk] (a tile: [P][B n][n]), S and Q as [P][B]
// [n]; boxes of one round: C's G genes (a tile's ts x ts), S and Q of G
// genes' rows (a tile: ts rows).
bool tail_maps(const TailArgs& a, TailMaps& m) {
  const long long n = a.n, B = a.B, P = a.P;
  const int NS = a.stages;
  const bool ok_c =
      a.nt == 1
          ? encode_box3(&m.C, a.C, a.chunk, B * n * n / a.chunk, P,
                        4LL * a.chunk, 4 * B * n * n, a.chunk,
                        a.genes * n * n / a.chunk, NS)
          : encode_box3(&m.C, a.C, n, B * n, P, 4 * n, 4 * B * n * n, a.ts,
                        a.ts, NS);
  const int rows = a.nt == 1 ? a.genes : 1;
  return ok_c &&
         encode_box3(&m.S, a.S, n, B, P, 4 * n, 4 * B * n, a.ts, rows, NS) &&
         encode_box3(&m.Q, a.Q, n, B, P, 4 * n, 4 * B * n, a.ts, rows, NS);
}

template <bool kStats, int kPP>
cudaError_t launch_tail(const TailMaps& m, const TailArgs& a, int smem,
                        unsigned grid, cudaStream_t st) {
  cudaError_t e = allow_smem(gene_tail_kernel<kStats, kPP>, smem);
  if (e != cudaSuccess) return e;
  constexpr int threads = tail_block<kPP>();
  gene_tail_kernel<kStats, kPP><<<grid, threads, smem, st>>>(m, a);
  return cudaGetLastError();
}

template <bool kStats>
cudaError_t launch_tail(const TailMaps& m, const TailArgs& a, int smem,
                        unsigned grid, cudaStream_t st) {
  const int pairs = a.genes * a.ts * a.ts;
  if (pairs <= kThreads) return launch_tail<kStats, 1>(m, a, smem, grid, st);
  if (pairs <= 4 * kThreads)
    return launch_tail<kStats, 4>(m, a, smem, grid, st);
  return launch_tail<kStats, 16>(m, a, smem, grid, st);
}

}  // namespace

// C [P, B, n, n], S and Q [P, B, n] (float32, exact integers) of the int8
// gene blocks X [B, n, S] over the segments [bounds[k], bounds[k + 1]).
// n is 8, 16 or a multiple of 32; S a multiple of 16 and X 16-byte
// aligned; bounds (host) nondecreasing within [0, S]; P <= 64.  A block
// of ``warps`` warps takes the consecutive segments [group[g], group[g +
// 1]) of one gene (and 32 x 32 tile), g < groups: group (host) rises from
// 0 to P, at most 16 segments a group (8 when n >= 32).
extern "C" int gauss_gene_partials(const void* X, long long S, int B, int n,
                                   int P, const int* bounds, int groups,
                                   const int* group, int warps, void* C,
                                   void* Ssum, void* Q, void* stream) {
  if (P < 1 || P > kMaxPops || S <= 0 || S % 16 || warps < 1 ||
      warps > kPartialsMaxWarps || groups < 1 || groups > P ||
      !(n == 8 || n == 16 || (n > 0 && n % 32 == 0)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Segments seg{};
  for (int k = 0; k < P; ++k) {
    if (bounds[k] < 0 || bounds[k] > bounds[k + 1] || bounds[k + 1] > S)
      return (int)cudaErrorInvalidValue;
    seg.lo[k] = bounds[k];
    seg.hi[k] = bounds[k + 1];
  }
  if (group[0] != 0 || group[groups] != P)
    return (int)cudaErrorInvalidValue;
  for (int g = 0; g <= groups; ++g) {
    if (g < groups && group[g] >= group[g + 1])
      return (int)cudaErrorInvalidValue;
    seg.group[g] = group[g];
  }
  const int8_t* x = (const int8_t*)X;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 8)
    return (int)launch_partials<8>(x, S, B, n, groups, seg, warps,
                                   (float*)C, (float*)Ssum, (float*)Q, st);
  if (n == 16)
    return (int)launch_partials<16>(x, S, B, n, groups, seg, warps,
                                    (float*)C, (float*)Ssum, (float*)Q, st);
  return (int)launch_partials<32>(x, S, B, n, groups, seg, warps, (float*)C,
                                  (float*)Ssum, (float*)Q, st);
}

// From the partials C, S, Q of B genes (bucket size n: a power of two >=
// 8), the float64 combine: consts (host) holds wf, m, w and 1 / m, P each
// (weighted), npool the pooled sum of the true sizes.  stats 0: CorG into
// out0 [B, n, n].  stats 1: CovU into out0, WWt into out1 [B, 6, 6] and U
// into out2 [B, 6] from ids [B n] (< 0: pad row) and Wz [B n, 7]; with
// more than one tile a gene (n > 64), scratch holds B (n / 64)^2 x 36
// doubles and tickets B ints (zeroed here).  A block takes ``genes``
// genes (n <= 64) and streams the populations through ``stages`` stages.
// C, S, Q, ids and Wz are 16-byte aligned.
extern "C" int gauss_gene_tail(const void* C, const void* S, const void* Q,
                               int P, int B, int n, int pooled,
                               const double* consts, double npool,
                               double ridge, const void* ids, const void* Wz,
                               void* out0, void* out1, void* out2,
                               void* scratch, void* tickets, int genes,
                               int stages, int stats, void* stream) {
  const int tiles = n > kPairTile ? (n / kPairTile) * (n / kPairTile) : 1;
  auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  if (P < 1 || P > kMaxPops || n < 8 || (n & (n - 1)) || misaligned(C) ||
      misaligned(S) || misaligned(Q) ||
      (stats && (ids == nullptr || Wz == nullptr || out1 == nullptr ||
                 out2 == nullptr || misaligned(ids) || misaligned(Wz) ||
                 (tiles > 1 && (scratch == nullptr || tickets == nullptr)))))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  TailArgs a{};
  a.C = (const float*)C;
  a.S = (const float*)S;
  a.Q = (const float*)Q;
  a.ids = (const int32_t*)ids;
  a.Wz = (const double*)Wz;
  a.out0 = (double*)out0;
  a.out1 = (double*)out1;
  a.out2 = (double*)out2;
  a.scratch = (double*)scratch;
  a.tickets = (int*)tickets;
  a.P = P;
  a.B = B;
  a.n = n;
  a.pooled = pooled != 0;
  a.npool = npool;
  a.ridge = ridge;
  int smem = 0;
  if (!tail_layout(a, stats, genes, stages, &smem))
    return (int)cudaErrorInvalidValue;
  if (!pooled)
    for (int w = 0; w < 4; ++w)
      for (int k = 0; k < P; ++k) a.cst[w][k] = consts[w * P + k];
  TailMaps maps;
  if (!tail_maps(a, maps)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid =
      a.nt == 1 ? static_cast<unsigned>((B + a.genes - 1) / a.genes)
                : static_cast<unsigned>(B) * tiles;
  if (stats) {
    if (tiles > 1) {
      cudaError_t e = cudaMemsetAsync(tickets, 0, sizeof(int) * B, st);
      if (e != cudaSuccess) return (int)e;
    }
    return (int)launch_tail<true>(maps, a, smem, grid, st);
  }
  return (int)launch_tail<false>(maps, a, smem, grid, st);
}

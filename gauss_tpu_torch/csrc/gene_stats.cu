// Gene statistics of jepeg / jepegmix: the per-population partials of a
// bucket of gathered gene blocks, and the float64 combine, ridge and W
// contractions that turn them into each gene's category statistics.
//
// No Pallas kernel corresponds to these.  On the TPU the work is one jitted
// XLA program, gauss_tpu/core/genekernels.py:222 (_gene_stats_unsharded,
// body :179-219, the combine _corr_from_pop_partials :136-176): K2's gather,
// per-population f32 Grams, a float64 CalWgtCov combine, the 1 + lambda
// ridge and the contractions with W.  In the port that was ~4 torch launches
// a population for the partials and ~25 for the combine, per bucket.  Two
// entry points replace it (ops/gene_stats.py holds the wrappers and, beside
// each, the torch code it replaced as its plain version):
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
// What bounds them on this card: bytes, and at the main path's sizes the
// launches they replace.  jepegmix at 33,168 subject columns gathers ~3,700
// gene rows a call, ~120 MB of int8 that the partials read once; the
// partials' int8 products (B n^2 S / 2 multiply-adds, ~2 GOP) and the
// combine's float64 work (~10 operations per pair and population, tens of
// MFLOP) are far below what the card does in that time.
//
// What the design does about it:
//  * gene_partials: one block per (gene, 32 x 32 tile of C's lower
//    triangle, segment); the block walks its segment's columns in chunks,
//    each thread bringing one aligned 16-byte piece of a row into shared
//    memory with the bytes outside the segment zeroed (segments are not
//    padded: a piece may straddle two populations), then sums dp4a
//    products in int32 and converts once.  The block is never cast to f32
//    in memory.  An off-diagonal tile writes its transpose too (C is an
//    exact integer Gram, so both halves are the same bits); a diagonal
//    tile also writes S (dp4a against ones) and Q (C's diagonal).
//    Buckets of 8 and 16 rows take one 8 x 8 or 16 x 16 tile with wider
//    chunks, so that every thread still loads one piece a chunk.
//  * gene_tail: one block per (gene, 64 x 64 tile of pairs; one tile when
//    n <= 64).  Its first threads compute the tile's row and column
//    statistics (std and the weighted mean, a chain over populations),
//    then each thread computes its pairs' correlations and, in stats mode,
//    folds them straight into W R (six partial sums a column), so CorG is
//    never stored: a tile's 36 partial sums of W R W^T go to scratch, and
//    the gene's last tile to finish adds them in tile order (a ticket per
//    gene), with WWt and U.  Every step of the combine is one correctly
//    rounded float64 operation in the plain version's order
//    (__dadd_rn and friends keep nvcc from contracting them into FMAs),
//    so CorG equals the plain version's bit for bit on the card; the
//    contractions with W sum in another order.  s / m_k is computed as
//    s * (1 / m_k), the reciprocal taken on the host, as PyTorch's CUDA
//    division by a Python scalar computes it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPops = 64;             // segments / populations per call
constexpr int kPairTile = 64;            // gene_tail's tile side, at most

// ---------------------------------------------------------------- partials

struct Segments {
  int lo[kMaxPops];
  int hi[kMaxPops];
};

// tile side TI (8, 16 or 32) -> the block's work split
template <int TI>
struct Split {
  static constexpr int kOutputs = TI * TI;
  // threads sharing one output (each sums every kG-th word), outputs a
  // thread owns
  static constexpr int kG = kOutputs >= kThreads ? 1 : kThreads / kOutputs;
  static constexpr int kOwn = kOutputs >= kThreads ? kOutputs / kThreads : 1;
  // 32-bit words of a chunk row: TI rows x 4,096 / TI bytes, one 16-byte
  // piece a thread
  static constexpr int kWords = 1024 / TI;
  static constexpr int kBytes = 4 * kWords;
  static constexpr int kPieces = kBytes / 16;      // pieces of a chunk row
  static constexpr int kLd = kWords + kG;          // shared row stride
  static constexpr int kRowG = kThreads / TI;      // threads a row sum
  static_assert(TI * kPieces == kThreads, "one piece a thread");
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

template <int TI>
__global__ void __launch_bounds__(kThreads)
gene_partials_kernel(const int8_t* __restrict__ X, int64_t S, int B, int n,
                     int tiles, Segments seg, float* __restrict__ C,
                     float* __restrict__ Ssum, float* __restrict__ Q) {
  using Sp = Split<TI>;
  __shared__ uint32_t xs[TI * Sp::kLd];
  __shared__ uint32_t ys[TI * Sp::kLd];
  const int t = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  int I = 0;                                // lower-triangle tile (I >= J)
  while ((I + 1) * (I + 2) / 2 <= tile) ++I;
  const int J = tile - I * (I + 1) / 2;
  const bool diag = I == J;
  const int k = blockIdx.y;
  const int lo = seg.lo[k], hi = seg.hi[k];
  const int64_t a0 = lo & ~15;
  int64_t a1 = (static_cast<int64_t>(hi) + 15) & ~static_cast<int64_t>(15);
  if (a1 > S) a1 = S;

  // this thread's piece of a chunk: row lr, bytes 16 lq ..
  const int lr = t / Sp::kPieces, lq = t % Sp::kPieces;
  const int8_t* xrow = X + (static_cast<int64_t>(b) * n + I * TI + lr) * S;
  const int8_t* yrow = X + (static_cast<int64_t>(b) * n + J * TI + lr) * S;
  // this thread's outputs: rows i_r, column j, words part, part + kG, ..
  const int part = t % Sp::kG;
  const int obase = t / Sp::kG;
  const int j = obase % TI;
  int acc[Sp::kOwn];
#pragma unroll
  for (int r = 0; r < Sp::kOwn; ++r) acc[r] = 0;
  int rs = 0;
  const int ri = t / Sp::kRowG, rp = t % Sp::kRowG;   // row-sum share

  for (int64_t c0 = a0; c0 < a1; c0 += Sp::kBytes) {
    const int64_t col = c0 + 16 * lq;
    uint32_t wx[4], wy[4];
    load_piece(xrow, col, lo, hi, a1, wx);
    if (!diag) load_piece(yrow, col, lo, hi, a1, wy);
    __syncthreads();                        // the last chunk's reads done
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      xs[lr * Sp::kLd + 4 * lq + e] = wx[e];
      if (!diag) ys[lr * Sp::kLd + 4 * lq + e] = wy[e];
    }
    __syncthreads();
    const uint32_t* yb = diag ? xs : ys;
    for (int w = part; w < Sp::kWords; w += Sp::kG) {
      const int y = static_cast<int>(yb[j * Sp::kLd + w]);
#pragma unroll
      for (int r = 0; r < Sp::kOwn; ++r) {
        const int i = (obase + r * (kThreads / Sp::kG)) / TI;
        acc[r] = __dp4a(static_cast<int>(xs[i * Sp::kLd + w]), y, acc[r]);
      }
    }
    if (diag) {
      for (int w = rp; w < Sp::kWords; w += Sp::kRowG)
        rs = __dp4a(static_cast<int>(xs[ri * Sp::kLd + w]), 0x01010101, rs);
    }
  }

#pragma unroll
  for (int r = 0; r < Sp::kOwn; ++r)
    for (int off = Sp::kG / 2; off > 0; off /= 2)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  for (int off = Sp::kRowG / 2; off > 0; off /= 2)
    rs += __shfl_xor_sync(0xffffffffu, rs, off);

  const int64_t pb = static_cast<int64_t>(k) * B + b;   // (segment, gene)
  if (part == 0) {
#pragma unroll
    for (int r = 0; r < Sp::kOwn; ++r) {
      const int i = (obase + r * (kThreads / Sp::kG)) / TI;
      const int gi = I * TI + i, gj = J * TI + j;
      const float v = static_cast<float>(acc[r]);
      C[(pb * n + gi) * n + gj] = v;
      if (!diag) C[(pb * n + gj) * n + gi] = v;
      if (diag && i == j) Q[pb * n + gi] = v;
    }
  }
  if (diag && rp == 0) Ssum[pb * n + I * TI + ri] = static_cast<float>(rs);
}

template <int TI>
cudaError_t launch_partials(const int8_t* X, int64_t S, int B, int n, int P,
                            const Segments& seg, float* C, float* Ssum,
                            float* Q, cudaStream_t st) {
  const int nt = n / TI;
  const int tiles = nt * (nt + 1) / 2;
  const dim3 grid(static_cast<unsigned>(B) * tiles, P);
  gene_partials_kernel<TI><<<grid, kThreads, 0, st>>>(X, S, B, n, tiles, seg,
                                                      C, Ssum, Q);
  return cudaGetLastError();
}

// -------------------------------------------------------------------- tail

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
  double npool;                   // pooled: sum of the true sizes
  double ridge;                   // 1 + lambda
  double wf[kMaxPops];            // w_k m_k / (m_k - 1)
  double mk[kMaxPops];            // m_k, the true sizes
  double wk[kMaxPops];            // w_k
  double inv_mk[kMaxPops];        // 1 / m_k
};

// row r of gene b: (std, the weighted mean) weighted, (d, s) pooled, in the
// plain version's order
__device__ __forceinline__ void row_stats(const TailArgs& a, int b, int r,
                                          double& sd, double& m) {
  const int64_t pstride = static_cast<int64_t>(a.B) * a.n;
  const int64_t o = static_cast<int64_t>(b) * a.n + r;
  if (a.pooled) {
    double s = 0.0, q = 0.0;
    for (int k = 0; k < a.P; ++k) {
      s = __dadd_rn(s, static_cast<double>(a.S[k * pstride + o]));
      q = __dadd_rn(q, static_cast<double>(a.Q[k * pstride + o]));
    }
    sd = __dsqrt_rn(__dsub_rn(__dmul_rn(a.npool, q), __dmul_rn(s, s)));
    m = s;
    return;
  }
  double mi = 0.0, var = 0.0, vmimj = 0.0;
  for (int k = 0; k < a.P; ++k) {
    const double s = static_cast<double>(a.S[k * pstride + o]);
    const double q = static_cast<double>(a.Q[k * pstride + o]);
    const double sm = __dmul_rn(s, a.inv_mk[k]);
    const double ws = __dmul_rn(a.wk[k], sm);
    mi = __dadd_rn(mi, ws);
    var = __dadd_rn(var, __dmul_rn(a.wf[k], __dsub_rn(__dmul_rn(a.mk[k], q),
                                                      __dmul_rn(s, s))));
    vmimj = __dadd_rn(vmimj, __dmul_rn(ws, sm));
  }
  sd = __dsqrt_rn(__dsub_rn(__dadd_rn(var, vmimj), __dmul_rn(mi, mi)));
  m = mi;
}

// CorG[gi, gj] of gene b from its rows' (sd, m)
__device__ __forceinline__ double pair_corr(const TailArgs& a, int b, int gi,
                                            int gj, double sdi, double sdj,
                                            double mi, double mj) {
  const int64_t pstride = static_cast<int64_t>(a.B) * a.n;
  const int64_t oi = static_cast<int64_t>(b) * a.n + gi;
  const int64_t oj = static_cast<int64_t>(b) * a.n + gj;
  const int64_t oc = oi * a.n + gj;
  if (a.pooled) {
    double c0 = 0.0;
    for (int k = 0; k < a.P; ++k)
      c0 = __dadd_rn(c0, static_cast<double>(a.C[k * pstride * a.n + oc]));
    const double numer = __dsub_rn(__dmul_rn(a.npool, c0), __dmul_rn(mi, mj));
    return __ddiv_rn(numer, __dmul_rn(sdi, sdj));
  }
  double cov = 0.0, mimj = 0.0;
  for (int k = 0; k < a.P; ++k) {
    const double c = static_cast<double>(a.C[k * pstride * a.n + oc]);
    const double si = static_cast<double>(a.S[k * pstride + oi]);
    const double sj = static_cast<double>(a.S[k * pstride + oj]);
    cov = __dadd_rn(cov, __dmul_rn(a.wf[k],
                                   __dsub_rn(__dmul_rn(a.mk[k], c),
                                             __dmul_rn(si, sj))));
    const double smi = __dmul_rn(si, a.inv_mk[k]);
    const double smj = __dmul_rn(sj, a.inv_mk[k]);
    mimj = __dadd_rn(mimj, __dmul_rn(__dmul_rn(a.wk[k], smi), smj));
  }
  cov = __dsub_rn(__dadd_rn(cov, mimj), __dmul_rn(mi, mj));
  return __ddiv_rn(cov, __dmul_rn(sdi, sdj));
}

template <bool kStats>
__global__ void __launch_bounds__(kThreads) gene_tail_kernel(TailArgs a) {
  __shared__ double sd_s[2][kPairTile], m_s[2][kPairTile];
  __shared__ double w_s[2][6][kPairTile];     // stats: W of rows, columns
  __shared__ int real_s[2][kPairTile];
  __shared__ double part[6 * kThreads];       // stats: [group][6][column]
  __shared__ double prod[kPairTile * 36];     // stats: [column][36]
  __shared__ int last;
  const int n = a.n;
  const int TS = n < kPairTile ? n : kPairTile;
  const int nt = n / TS, tiles = nt * nt;
  const int b = blockIdx.x / tiles, tile = blockIdx.x - b * tiles;
  const int I = tile / nt, J = tile - I * nt;
  const int t = threadIdx.x;
  const int64_t row0 = static_cast<int64_t>(b) * n;

  // the tile's rows (threads [0, TS)) and columns ([TS, 2 TS))
  if (t < 2 * TS) {
    const int side = t / TS, c = t - side * TS;
    const int r = (side ? J : I) * TS + c;
    row_stats(a, b, r, sd_s[side][c], m_s[side][c]);
    if (kStats) {
      real_s[side][c] = a.ids[row0 + r] >= 0;
      for (int q = 0; q < 6; ++q) w_s[side][q][c] = a.Wz[(row0 + r) * 7 + q];
    }
  }
  __syncthreads();

  if (!kStats) {
    for (int e = t; e < TS * TS; e += kThreads) {
      const int i = e / TS, j = e - (e / TS) * TS;
      const int gi = I * TS + i, gj = J * TS + j;
      a.out0[(row0 + gi) * n + gj] = pair_corr(
          a, b, gi, gj, sd_s[0][i], sd_s[1][j], m_s[0][i], m_s[1][j]);
    }
    return;
  }

  // (W R)[q, column c] over this tile's rows, in G groups of rows
  const int G = kThreads / TS;
  const int c = t % TS, g = t / TS;
  const int gj = J * TS + c;
  double wc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int i = g; i < TS; i += G) {
    const int gi = I * TS + i;
    double R = pair_corr(a, b, gi, gj, sd_s[0][i], sd_s[1][c], m_s[0][i],
                         m_s[1][c]);
    // pad pairs are zero (a select: a pad row's NaN must not survive);
    // CorG (1 - eye) + (1 + lambda) eye: a real NaN diagonal stays NaN
    if (!(real_s[0][i] && real_s[1][c])) R = 0.0;
    R = gi == gj ? __dadd_rn(__dmul_rn(R, 0.0), __dmul_rn(a.ridge, 1.0))
                 : __dadd_rn(__dmul_rn(R, 1.0), __dmul_rn(a.ridge, 0.0));
#pragma unroll
    for (int q = 0; q < 6; ++q) wc[q] = fma(w_s[0][q][i], R, wc[q]);
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) part[(g * 6 + q) * TS + c] = wc[q];
  __syncthreads();
  if (t < TS) {
    double col[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      double s = 0.0;
      for (int h = 0; h < G && h < TS; ++h) s += part[(h * 6 + q) * TS + t];
      col[q] = s;
    }
#pragma unroll
    for (int q = 0; q < 6; ++q)
#pragma unroll
      for (int l = 0; l < 6; ++l)
        prod[t * 36 + q * 6 + l] = col[q] * w_s[1][l][t];
  }
  __syncthreads();
  double tv = 0.0;
  if (t < 36)
    for (int h = 0; h < TS; ++h) tv += prod[h * 36 + t];

  if (tiles > 1) {
    if (t < 36) a.scratch[(static_cast<int64_t>(b) * tiles + tile) * 36 + t] = tv;
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(&a.tickets[b], 1) == tiles - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (t < 36) {
      tv = 0.0;
      for (int h = 0; h < tiles; ++h)
        tv += __ldcg(&a.scratch[(static_cast<int64_t>(b) * tiles + h) * 36 + t]);
    }
    if (t == 0) a.tickets[b] = 0;
  }
  // the gene's CovU, then WWt and U over all its rows
  if (t < 36) {
    a.out0[static_cast<int64_t>(b) * 36 + t] = tv;
    const int q = t / 6, l = t - (t / 6) * 6;
    double s = 0.0;
    for (int r = 0; r < n; ++r)
      s = fma(a.Wz[(row0 + r) * 7 + q], a.Wz[(row0 + r) * 7 + l], s);
    a.out1[static_cast<int64_t>(b) * 36 + t] = s;
  } else if (t < 42) {
    const int q = t - 36;
    double s = 0.0;
    for (int r = 0; r < n; ++r)
      s = fma(a.Wz[(row0 + r) * 7 + q], a.Wz[(row0 + r) * 7 + 6], s);
    a.out2[static_cast<int64_t>(b) * 6 + q] = s;
  }
}

}  // namespace

// C [P, B, n, n], S and Q [P, B, n] (float32, exact integers) of the int8
// gene blocks X [B, n, S] over the segments [bounds[k], bounds[k + 1]).
// n is 8, 16 or a multiple of 32; S a multiple of 16 and X 16-byte
// aligned; bounds (host) nondecreasing within [0, S]; P <= 64.
extern "C" int gauss_gene_partials(const void* X, long long S, int B, int n,
                                   int P, const int* bounds, void* C,
                                   void* Ssum, void* Q, void* stream) {
  if (P < 1 || P > kMaxPops || S <= 0 || S % 16 ||
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
  const int8_t* x = (const int8_t*)X;
  cudaStream_t st = (cudaStream_t)stream;
  if (n == 8)
    return (int)launch_partials<8>(x, S, B, n, P, seg, (float*)C,
                                   (float*)Ssum, (float*)Q, st);
  if (n == 16)
    return (int)launch_partials<16>(x, S, B, n, P, seg, (float*)C,
                                    (float*)Ssum, (float*)Q, st);
  return (int)launch_partials<32>(x, S, B, n, P, seg, (float*)C,
                                  (float*)Ssum, (float*)Q, st);
}

// tiles of gene_tail per gene at bucket size n (its scratch holds 36
// doubles a tile when there is more than one)
extern "C" int gauss_gene_tail_tiles(int n) {
  const int ts = n < kPairTile ? n : kPairTile;
  return ts > 0 ? (n / ts) * (n / ts) : 0;
}

// From the partials C, S, Q of B genes (bucket size n: 8, 16, 32, 64 or a
// multiple of 64), the float64 combine: consts (host) holds wf, m, w and
// 1 / m, P each (weighted), npool the pooled sum of the true sizes.
// stats 0: CorG into out0 [B, n, n].  stats 1: CovU into out0, WWt into
// out1 [B, 6, 6] and U into out2 [B, 6] from ids [B n] (< 0: pad row) and
// Wz [B n, 7]; with more than one tile a gene, scratch holds B tiles 36
// doubles and tickets B ints (zeroed here).
extern "C" int gauss_gene_tail(const void* C, const void* S, const void* Q,
                               int P, int B, int n, int pooled,
                               const double* consts, double npool,
                               double ridge, const void* ids, const void* Wz,
                               void* out0, void* out1, void* out2,
                               void* scratch, void* tickets, int stats,
                               void* stream) {
  const int tiles = gauss_gene_tail_tiles(n);
  if (P < 1 || P > kMaxPops || n < 8 || (n & (n - 1)) ||
      (stats && (ids == nullptr || Wz == nullptr || out1 == nullptr ||
                 out2 == nullptr ||
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
  if (!pooled) {
    for (int k = 0; k < P; ++k) {
      a.wf[k] = consts[k];
      a.mk[k] = consts[P + k];
      a.wk[k] = consts[2 * P + k];
      a.inv_mk[k] = consts[3 * P + k];
    }
  }
  cudaStream_t st = (cudaStream_t)stream;
  const unsigned grid = static_cast<unsigned>(B) * tiles;
  if (stats) {
    if (tiles > 1) {
      cudaError_t e = cudaMemsetAsync(tickets, 0, sizeof(int) * B, st);
      if (e != cudaSuccess) return (int)e;
    }
    gene_tail_kernel<true><<<grid, kThreads, 0, st>>>(a);
  } else {
    gene_tail_kernel<false><<<grid, kThreads, 0, st>>>(a);
  }
  return (int)cudaGetLastError();
}

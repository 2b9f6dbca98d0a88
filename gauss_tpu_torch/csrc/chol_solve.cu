// Region tail: the batched Cholesky factorization of B11 and the forward
// solve of the right-hand side [B21^T | Z1], the last stage of the impute
// and qcat region kernels.
//
// Replaces gauss_tpu/ops/window_kernel.py:1160-1258 (_blocked_cholesky_lower
// and _blocked_trsm_lower, XLA at Precision.HIGHEST on the TPU; no Pallas
// kernel corresponds) and, in the port, the library pair
// torch.linalg.cholesky_ex + solve_triangular (cuSOLVER's batched potrf,
// cuBLAS's batched trsm, the gemms inside them, the zeroing of L's upper
// triangle and the input copies).  ops/region_tail.py holds the wrapper and,
// beside it, that pair as the plain version.
//
// For each window w of a slab (Mp a multiple of 64, K >= 1 columns):
//
//   B11[w] = L L^T   read from B11's lower triangle only (row-major);
//   Y[w]   = L^-1 rhs[w], rhs [Mp, K] column-major (element (m, u) at
//            u * Mp + m), the layout corr_um_rhs writes;
//   info[w] = 0, or the 1-based index of the first pivot that is not
//            positive (NaN included), as LAPACK's potrf and cholesky_ex.
//
// Both are written in place: L over B11's lower triangle (the diagonal
// tiles' strict upper triangle zeroed; with want_l the strict upper
// triangle everywhere), Y over rhs; the only scratch is two 64 x 64 tiles
// a window.  A window whose factorization failed stops there: its L and Y
// are unspecified (the callers set its results to NaN from info).
//
// What bounds it on this card: f32 FMAs.  At the main path's shape (W = 43
// windows, Mp = 1280, K = Up + 1 = 961) the factorization is W Mp^3 / 3 =
// 30.1 GFLOP and the solve W Mp^2 K = 67.7 GFLOP: ~1.46 ms at the 67 TFLOP/s
// of f32 outside the tensor cores.  The bytes (B11's lower triangle and the
// right-hand side read, Y written, ~0.56 GB) take ~0.17 ms at 3.35 TB/s.
//
// What the design does about it.  Everything works on 64 x 64 tiles, held
// by 128 threads as 8 rows x 4 columns each (rows 8 tr + i, columns
// tc + 16 e), in registers:
//  * the factorization is left-looking by 64-wide block columns, two
//    launches per block column j, queued back to back with no host sync.
//    The diagonal step (a block a window) factors D_jj = Dpart_j -
//    L_j,j-1 L_j,j-1^T in shared memory.  The panel step's block (w, i)
//    forms C = A_ij - L_i,<j L_j,<j^T (a tile product of depth 64 j) and
//    solves L_ij = C L_jj^-T; one more block a window forms the next
//    diagonal tile's partial sum Dpart_j+1 = A_j+1,j+1 - L_j+1,<j
//    L_j+1,<j^T, so every block does one product of the same depth and
//    the diagonal step's own product is 64 deep;
//  * the forward solve is one launch per row block j over (64-column tile
//    of rhs, window), no dependency between the blocks of a launch:
//    Y_j = L_jj^-1 (R_j - L_j,<j Y_<j), reading back Y_<j.  Solve launch
//    j waits (an event) only for diagonal step j; the factorization runs
//    on a stream of its own at the device's highest priority, so the
//    solve's row blocks fill the card beside its narrow last launches;
//  * the tile products, ~all of the FMAs, run from shared memory: both
//    operands' 64 rows x 32 k of a chunk land by cp.async (16 bytes a
//    thread, zero-filled past the last column) in a double-buffered ring,
//    read as float4 along k; each thread does 8 x 4 x 4 FMAs per 12
//    16-byte loads, without bank conflicts (rows 36 floats apart);
//  * the in-tile triangular steps keep the tile in registers and take few
//    barriers: the substitutions (the solve's, and the panel's posed as
//    L_jj L_ij^T = C^T) go by blocks of 8 rows, each solved by the 16
//    threads that hold it and then taken off the later rows (8 barriers a
//    tile); the 64 x 64 factorization pivot by pivot (the pivot's column
//    published, one barrier, every thread updating its 32 elements: a
//    blocked one, a warp factoring each 8-column block with shuffles, took
//    longer).  One reciprocal square root per pivot, correctly rounded
//    (__frsqrt_rn, __frcp_rn: no branch to nvcc's slow IEEE paths), and
//    LAPACK's scaling by it;
//  * accuracy: the running tile of a product starts as the input tile, and
//    each 64 k of products is summed apart and taken off it with Kahan's
//    compensation (tile_product), which keeps the kernel within ~1.5x of
//    the library pair's distance from a float64 solve (PERF.md);
//  * TF32: with torch.backends.cuda.matmul.allow_tf32 on, the wrapper asks
//    for the tile products' operands (the L and Y tiles) to be rounded to
//    TF32 as they land in shared memory; the triangular steps stay f32.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kT = 64;                // tile side
constexpr int kThreads = 128;         // 16 column x 8 row threads
constexpr int kKc = 32;               // k of one product chunk
constexpr int kSc = kKc + 4;          // chunk row stride (floats)
constexpr int kChunk = kT * kSc;      // one operand's chunk
constexpr int kRing = 2 * 2 * kChunk;  // two stages of A and B
constexpr int kSt = kT + 4;           // row stride of cp.async'd tiles
constexpr int kSp = kT + 1;           // row stride of the pivot buffer
// dynamic shared memory, floats: factorization steps = ring (aliased by
// L_jj's columns or by the panel) + L_jj + its pivots and their
// reciprocals; solve = ring + L_jj + the Y tile + 1 / pivots
constexpr int kFactorFloats = kRing + kT * kSt + 2 * kT;
constexpr int kSolveFloats = kRing + 2 * kT * kSt + kT;
static_assert(kT * kSt <= kRing && kT * kSp <= kRing, "tiles alias the ring");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, 64) x k [k0, k0 + 32) of a row-major operand (row stride ld)
// into a chunk [64][kSc]; rows at or past ``valid`` are zero-filled.  With
// kTF32 the thread rounds what it copied once it has landed (round_chunk).
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           int64_t ld, int k0, int valid) {
#pragma unroll
  for (int p = 0; p < kT * kKc / 4 / kThreads; ++p) {
    const int idx = threadIdx.x + p * kThreads, r = idx >> 3;
    const int k = (idx & 7) * 4;
    cp_async16(dst + r * kSc + k, src + (r < valid ? r * ld : 0) + k0 + k,
               r < valid);
  }
}

__device__ __forceinline__ void round_chunk(float* dst) {
#pragma unroll
  for (int p = 0; p < kT * kKc / 4 / kThreads; ++p) {
    const int idx = threadIdx.x + p * kThreads;
    float* x = dst + (idx >> 3) * kSc + (idx & 7) * 4;
#pragma unroll
    for (int q = 0; q < 4; ++q) x[q] = tf32_round(x[q]);
  }
}

using Tile = float[8][4];

// P += A B^T over one chunk: a[i] row 8 tr + i of A, b[e] row tc + 16 e of
// B, four k at a time.
__device__ __forceinline__ void chunk_fma(const float* As, const float* Bs,
                                          Tile& P) {
  const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
#pragma unroll
  for (int k = 0; k < kKc; k += 4) {
    float4 b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      b[e] = *reinterpret_cast<const float4*>(Bs + (tc + 16 * e) * kSc + k);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 a =
          *reinterpret_cast<const float4*>(As + (tr * 8 + i) * kSc + k);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        P[i][e] = fmaf(a.x, b[e].x, P[i][e]);
        P[i][e] = fmaf(a.y, b[e].y, P[i][e]);
        P[i][e] = fmaf(a.z, b[e].z, P[i][e]);
        P[i][e] = fmaf(a.w, b[e].w, P[i][e]);
      }
    }
  }
}

// P -= A[0:64, 0:depth] B[0:64, 0:depth]^T, both operands row-major with
// row stride ld; B's rows at or past b_valid read as zero.  P starts as the
// tile the products come off.  Each 64 k (two chunks) is summed apart and
// then taken off P with a compensation term (Kahan's), so the running
// value, which shrinks towards the result (a pivot is small), keeps no
// error of its own updates: without the compensation the kernel was ~2x
// further from a float64 solve than the library pair on the main path's
// blocks (chip_smoke.py), with one subtraction per product further still.
// Chunks of 32 k stream through the two-stage ring.
// The caller's own cp.async groups, committed before, have landed and are
// visible on return (every path ends in a barrier after
// cp_async_wait<0>), and the ring is free again.
template <bool kTF32>
__device__ __forceinline__ void tile_product(const float* A, const float* B,
                                             int64_t ld, int depth,
                                             int b_valid, float* ring,
                                             Tile& P) {
  const int n = depth / kKc;
  Tile Q, C;                               // a 64-k sum, the compensation
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) C[i][e] = 0.0f;
  if (n == 0) {
    cp_async_wait<0>();
    __syncthreads();
    return;
  }
  load_chunk(ring, A, ld, 0, kT);
  load_chunk(ring + kChunk, B, ld, 0, b_valid);
  cp_async_commit();
  for (int c = 0; c < n; ++c) {
    float* st = ring + (c & 1) * 2 * kChunk;
    if (c + 1 < n) {
      float* nx = ring + ((c + 1) & 1) * 2 * kChunk;
      load_chunk(nx, A, ld, (c + 1) * kKc, kT);
      load_chunk(nx + kChunk, B, ld, (c + 1) * kKc, b_valid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if constexpr (kTF32) {
      round_chunk(st);
      round_chunk(st + kChunk);
    }
    __syncthreads();
    if ((c & 1) == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) Q[i][e] = 0.0f;
    }
    chunk_fma(st, st + kChunk, Q);
    if ((c & 1) == 1 || c + 1 == n) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float y = -Q[i][e] - C[i][e];
          const float t = P[i][e] + y;
          C[i][e] = (t - P[i][e]) - y;
          P[i][e] = t;
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) P[i][e] -= C[i][e];
}

// P = S (kTrans: S^T), S a 64 x 64 row-major tile in global memory (row
// stride ld), read straight into each thread's elements.
template <bool kTrans = false>
__device__ __forceinline__ void load_regs(const float* src, int64_t ld,
                                          Tile& P) {
  const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int a = tr * 8 + r, b = tc + 16 * e;
      P[r][e] = src[kTrans ? (int64_t)b * ld + a : (int64_t)a * ld + b];
    }
}

// P = L^-1 P for L lower triangular (Ls [64][kSt] row-major, its strict
// lower triangle read; rq the reciprocals of its diagonal), by blocks of 8
// rows.  The 16 threads holding row block b solve its 8 x 8 diagonal block
// on their own columns (each column is one thread's: no barrier), scaling
// by 1 / L_qq, and publish the block's 8 final rows; after one barrier the
// threads of the later row blocks subtract L_r,b X_b, 8 FMAs an element in
// the order of the unblocked substitution.  Every final row lands in ys
// [column][row] (ys[(tc + 16 e) * kSt + row]): 8 barriers for the tile.
__device__ __forceinline__ void left_solve(Tile& P, const float* Ls,
                                           const float* rq, float* ys) {
  const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
  for (int b = 0; b < 8; ++b) {
    const float* Lb = Ls + b * 8;
    if (tr == b) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float r = rq[b * 8 + q];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          P[q][e] *= r;
#pragma unroll
          for (int i = q + 1; i < 8; ++i)
            P[i][e] = fmaf(-Lb[(b * 8 + i) * kSt + q], P[q][e], P[i][e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float4* dst = reinterpret_cast<float4*>(ys + (tc + 16 * e) * kSt +
                                                b * 8);
        dst[0] = make_float4(P[0][e], P[1][e], P[2][e], P[3][e]);
        dst[1] = make_float4(P[4][e], P[5][e], P[6][e], P[7][e]);
      }
    }
    __syncthreads();
    if (tr > b) {
      float4 y[4][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4* src =
            reinterpret_cast<const float4*>(ys + (tc + 16 * e) * kSt + b * 8);
        y[e][0] = src[0];
        y[e][1] = src[1];
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4* lp =
            reinterpret_cast<const float4*>(Lb + (tr * 8 + i) * kSt);
        const float4 l0 = lp[0], l1 = lp[1];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = P[i][e];
          p = fmaf(-l0.x, y[e][0].x, p);
          p = fmaf(-l0.y, y[e][0].y, p);
          p = fmaf(-l0.z, y[e][0].z, p);
          p = fmaf(-l0.w, y[e][0].w, p);
          p = fmaf(-l1.x, y[e][1].x, p);
          p = fmaf(-l1.y, y[e][1].y, p);
          p = fmaf(-l1.z, y[e][1].z, p);
          P[i][e] = fmaf(-l1.w, y[e][1].w, p);
        }
      }
    }
  }
}

// A 64 x 64 row-major tile (row stride ld) into shared memory [64][kSt].
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t ld) {
#pragma unroll
  for (int p = 0; p < kT * kT / 4 / kThreads; ++p) {
    const int idx = threadIdx.x + p * kThreads, r = idx >> 4;
    const int c = (idx & 15) * 4;
    cp_async16(dst + r * kSt + c, src + r * ld + c, true);
  }
}

// The window's info, read once by the block's first thread, so that every
// thread of the block acts on one value.
__device__ __forceinline__ int block_info(const int32_t* info, int w,
                                          int* slot) {
  if (threadIdx.x == 0) *slot = info[w];
  __syncthreads();
  return *slot;
}

// Factor the tile D (registers, lower triangle meaningful) in place of
// itself: right-looking, one pivot a step.  Pivot q's column is published
// unscaled to col[q][.] by the threads that hold it; every thread then
// reads the pivot, takes 1 / l = 1 / sqrt(d) and updates its elements with
// the scaled column: one barrier a pivot.  col[q][r] / l is L[r][q] for
// r > q; lq / rq get each pivot and its reciprocal (1 / sqrt(d) correctly
// rounded, off the chain of the square root).  Returns 0 or the 1-based
// index (in the tile) of the first pivot that is not positive.
__device__ __forceinline__ int factor_tile(Tile& D, float* col, float* lq,
                                           float* rq) {
  const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    for (int cc = 0; cc < 16; ++cc) {
      const int q = 16 * e + cc;
      if (tc == cc) {
#pragma unroll
        for (int i = 0; i < 8; ++i) col[q * kSp + tr * 8 + i] = D[i][e];
      }
      __syncthreads();
      const float d = col[q * kSp + q];
      if (!(d > 0.0f)) return q + 1;
      const float r = __frsqrt_rn(d);
      if (threadIdx.x == 0) {
        lq[q] = __fsqrt_rn(d);
        rq[q] = r;
      }
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = col[q * kSp + tr * 8 + i] * r;
#pragma unroll
      for (int f = 0; f < 4; ++f) b[f] = col[q * kSp + tc + 16 * f] * r;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int f = 0; f < 4; ++f) D[i][f] = fmaf(-a[i], b[f], D[i][f]);
    }
  }
  __syncthreads();
  return 0;
}

// Window w's tiles of A and its two partial-sum slots.
struct Win {
  float* A;
  float* dpart;
  int Mp, W, w;
  __device__ float* tile(int r, int c) const {
    return A + ((int64_t)w * Mp + (int64_t)r * kT) * Mp + c * kT;
  }
  __device__ float* slot(int k) const {
    return dpart + ((int64_t)(k & 1) * W + w) * kT * kT;
  }
};

// Diagonal step j of window w (block y): L_jj = chol(D), D = A_00 at j = 0,
// else Dpart_j - L_j,j-1 L_j,j-1^T (Dpart_j left by panel step j - 1 in
// dpart slot j % 2), written over A_jj with its strict upper triangle zero,
// and the window's info.
template <bool kTF32>
__global__ void __launch_bounds__(kThreads, 3)
chol_diag_kernel(float* __restrict__ A, float* __restrict__ dpart,
                 int32_t* __restrict__ info, int Mp, int j) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int info_slot;
  float* ring = sm;
  float* col = ring;                       // L_jj's columns, unscaled
  float* Ls = ring + kRing;                // L_jj, row-major [64][kSt]
  float* rq = Ls + kT * kSt;               // 1 / pivots of L_jj
  float* lq = rq + kT;                     // pivots of L_jj
  const int w = blockIdx.y;
  const Win win{A, dpart, Mp, (int)gridDim.y, w};
  if (j > 0 && block_info(info, w, &info_slot) != 0) return;
  Tile P;
  if (j == 0) {
    load_regs(win.tile(0, 0), Mp, P);
  } else {
    const float* prev = win.tile(j, j - 1);
    load_regs(win.slot(j), kT, P);
    tile_product<kTF32>(prev, prev, Mp, kT, kT, ring, P);
  }
  const int bad = factor_tile(P, col, lq, rq);
  if (threadIdx.x == 0) info[w] = bad ? j * kT + bad : 0;
  if (bad) return;
  for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
    const int r = idx >> 6, c = idx & 63;
    Ls[r * kSt + c] =
        c < r ? col[c * kSp + r] * rq[c] : (c == r ? lq[c] : 0.0f);
  }
  __syncthreads();
#pragma unroll
  for (int p = 0; p < kT * kT / 4 / kThreads; ++p) {
    const int idx = threadIdx.x + p * kThreads, r = idx >> 4;
    const int c = (idx & 15) * 4;
    *reinterpret_cast<float4*>(win.tile(j, j) + (int64_t)r * Mp + c) =
        *reinterpret_cast<const float4*>(Ls + r * kSt + c);
  }
}

// Panel step j (j < Mp / 64 - 1) of window w (block y).  Block x >= 1:
// C^T = A_ij^T - L_j,<j L_i,<j^T, i = j + x, then L_jj L_ij^T = C^T by
// left_solve, which leaves L_ij row-major in shared memory; with want_l,
// zeros over A_ji.  Block x = 0: the next diagonal tile's partial sum
// Dpart_j+1 = A_j+1,j+1 - L_j+1,<j L_j+1,<j^T into dpart slot (j + 1) % 2.
// Every block does one tile product of depth 64 j.
template <bool kTF32>
__global__ void __launch_bounds__(kThreads, 3)
chol_panel_kernel(float* __restrict__ A, float* __restrict__ dpart,
                  const int32_t* __restrict__ info, int Mp, int j,
                  int want_l) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int info_slot;
  float* ring = sm;
  float* xs = ring;                        // L_ij, row-major [64][kSt]
  float* Ls = ring + kRing;                // L_jj, row-major [64][kSt]
  float* rq = Ls + kT * kSt;               // 1 / pivots of L_jj
  const int w = blockIdx.y, x = blockIdx.x;
  const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
  const Win win{A, dpart, Mp, (int)gridDim.y, w};
  if (block_info(info, w, &info_slot) != 0) return;
  Tile P;
  if (x == 0) {
    const int i = j + 1;
    load_regs(win.tile(i, i), Mp, P);
    tile_product<kTF32>(win.tile(i, 0), win.tile(i, 0), Mp, j * kT, kT, ring,
                        P);
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        win.slot(i)[(tr * 8 + r) * kT + tc + 16 * e] = P[r][e];
    return;
  }
  const int i = j + x;
  load_tile(Ls, win.tile(j, j), Mp);
  cp_async_commit();
  load_regs<true>(win.tile(i, j), Mp, P);
  tile_product<kTF32>(win.tile(j, 0), win.tile(i, 0), Mp, j * kT, kT, ring,
                      P);
  if (threadIdx.x < kT) rq[threadIdx.x] =
      __frcp_rn(Ls[threadIdx.x * kSt + threadIdx.x]);
  __syncthreads();
  left_solve(P, Ls, rq, xs);
  // L_ij out, coalesced along its rows; with want_l, zeros to (j, i)
#pragma unroll
  for (int p = 0; p < kT * kT / 4 / kThreads; ++p) {
    const int idx = threadIdx.x + p * kThreads, r = idx >> 4;
    const int c = (idx & 15) * 4;
    *reinterpret_cast<float4*>(win.tile(i, j) + (int64_t)r * Mp + c) =
        *reinterpret_cast<const float4*>(xs + r * kSt + c);
    if (want_l)
      *reinterpret_cast<float4*>(win.tile(j, i) + (int64_t)r * Mp + c) =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Row block j of the forward solve of one 64-column tile x of window w's
// right-hand side (column-major, column u at Y + u * Mp; columns at or past
// K are not touched), in place: Y_j = L_jj^-1 (R_j - L_j,<j Y_<j), Y_<j as
// the launches before it left it.
template <bool kTF32>
__global__ void __launch_bounds__(kThreads, 3)
forward_solve_kernel(const float* __restrict__ L, float* __restrict__ Y,
                     const int32_t* __restrict__ info, int Mp, int K, int j) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int info_slot;
  float* ring = sm;
  float* Ls = sm + kRing;                  // L_jj [64][kSt]
  float* ys = Ls + kT * kSt;               // Y_j, [column][row]
  float* rq = ys + kT * kSt;
  const int w = blockIdx.y, u0 = blockIdx.x * kT;
  const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
  if (block_info(info, w, &info_slot) != 0) return;
  const float* Lw = L + (int64_t)w * Mp * Mp;
  float* Yw = Y + (int64_t)w * K * Mp + (int64_t)u0 * Mp;
  const int valid = K - u0 < kT ? K - u0 : kT;
  Tile P;
  load_tile(Ls, Lw + (int64_t)j * kT * Mp + j * kT, Mp);
  cp_async_commit();
  // P = R_j, 8 rows of a column a thread (16-byte loads)
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int u = tc + 16 * e;
    float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f), hi = lo;
    if (u < valid) {
      const float4* src = reinterpret_cast<const float4*>(
          Yw + (int64_t)u * Mp + j * kT + tr * 8);
      lo = src[0];
      hi = src[1];
    }
    const float r[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) P[i][e] = r[i];
  }
  // P -= L_j,<j Y_<j: Y_<j's columns are rows of the B operand
  tile_product<kTF32>(Lw + (int64_t)j * kT * Mp, Yw, Mp, j * kT, valid, ring,
                      P);
  if (threadIdx.x < kT) rq[threadIdx.x] =
      __frcp_rn(Ls[threadIdx.x * kSt + threadIdx.x]);
  __syncthreads();
  left_solve(P, Ls, rq, ys);                   // Y_j into ys
  // Y_j out over R_j, coalesced along the columns
#pragma unroll
  for (int p = 0; p < kT * kT / 4 / kThreads; ++p) {
    const int idx = threadIdx.x + p * kThreads, u = idx >> 4;
    const int m = (idx & 15) * 4;
    if (u < valid)
      *reinterpret_cast<float4*>(Yw + (int64_t)u * Mp + j * kT + m) =
          *reinterpret_cast<const float4*>(ys + u * kSt + m);
  }
}

// The factorization's stream, of the device's highest priority, and an
// event to order it with the caller's, one pair per device, made at first
// use and kept.  The lock also keeps two host threads' launch sequences
// from interleaving on them.
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t ev = nullptr;
};

std::mutex side_lock;

cudaError_t side_for(Side* out) {
  static Side table[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  Side& s = table[dev];
  if (s.stream == nullptr) {
    int least = 0, greatest = 0;
    if ((e = cudaDeviceGetStreamPriorityRange(&least, &greatest)) !=
            cudaSuccess ||
        (e = cudaEventCreateWithFlags(&s.ev, cudaEventDisableTiming)) !=
            cudaSuccess ||
        (e = cudaStreamCreateWithPriority(&s.stream, cudaStreamNonBlocking,
                                          greatest)) != cudaSuccess)
      return e;
  }
  *out = s;
  return cudaSuccess;
}

// The factorization's launches go to the side stream, each row block of
// the solve to the caller's stream once the diagonal step it needs has
// run: the solve's row blocks fill the card beside the factorization's
// narrow last launches.  The caller's stream ends behind the last of both;
// nothing waits on the host.
template <bool kTF32>
int chol_solve(float* A, float* Y, float* dpart, int32_t* info, int W,
               int Mp, int K, int want_l, cudaStream_t st) {
  const int nb = Mp / kT, fbytes = kFactorFloats * 4,
            sbytes = kSolveFloats * 4;
  cudaError_t e = allow_smem(chol_diag_kernel<kTF32>, fbytes);
  if (e == cudaSuccess) e = allow_smem(chol_panel_kernel<kTF32>, fbytes);
  if (e == cudaSuccess) e = allow_smem(forward_solve_kernel<kTF32>, sbytes);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> hold(side_lock);
  Side side;
  if ((e = side_for(&side)) != cudaSuccess ||
      (e = cudaEventRecord(side.ev, st)) != cudaSuccess ||
      (e = cudaStreamWaitEvent(side.stream, side.ev, 0)) != cudaSuccess)
    return (int)e;
  for (int j = 0; j < nb; ++j) {
    chol_diag_kernel<kTF32><<<dim3(1, W), kThreads, fbytes, side.stream>>>(
        A, dpart, info, Mp, j);
    if ((e = cudaGetLastError()) != cudaSuccess ||
        (e = cudaEventRecord(side.ev, side.stream)) != cudaSuccess ||
        (e = cudaStreamWaitEvent(st, side.ev, 0)) != cudaSuccess)
      return (int)e;
    forward_solve_kernel<kTF32><<<dim3((K + kT - 1) / kT, W), kThreads,
                                  sbytes, st>>>(A, Y, info, Mp, K, j);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (j + 1 < nb) {
      chol_panel_kernel<kTF32><<<dim3(nb - j, W), kThreads, fbytes,
                                 side.stream>>>(A, dpart, info, Mp, j,
                                                want_l);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

}  // namespace

// dynamic shared memory of the factorization's and the solve's blocks,
// bytes (printed by chip_smoke.py)
extern "C" int gauss_chol_solve_smem(int solve) {
  return (solve ? kSolveFloats : kFactorFloats) * 4;
}

// In place, per window w < W: L over A[w]'s lower triangle (A [W, Mp, Mp]
// row-major, its lower triangle read; want_l zeroes the strict upper
// triangle), Y = L^-1 rhs over Y [W, K, Mp] in memory (rhs column-major),
// info [W] int32; dpart: scratch of 2 W 64 x 64 floats.  Mp a multiple of
// 64, K >= 1; A and Y 16-byte aligned.  2 Mp / 64 - 1 factorization
// launches on a stream of the library's own, Mp / 64 solve launches on
// ``stream``, which ends behind both.
extern "C" int gauss_chol_solve(void* A, void* Y, void* dpart, void* info,
                                int W, int Mp, int K, int want_l, int tf32,
                                void* stream) {
  if (Mp % kT || K < 1) return (int)cudaErrorInvalidValue;
  if (W <= 0 || Mp == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return tf32 ? chol_solve<true>((float*)A, (float*)Y, (float*)dpart,
                                 (int32_t*)info, W, Mp, K, want_l, st)
              : chol_solve<false>((float*)A, (float*)Y, (float*)dpart,
                                  (int32_t*)info, W, Mp, K, want_l, st);
}

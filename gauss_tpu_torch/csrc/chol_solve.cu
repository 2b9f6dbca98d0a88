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
// triangle everywhere), Y over rhs; the only scratch is the int32 progress
// counters the wrapper zeroes (info among them).  A window whose
// factorization failed stops there: its L and Y are unspecified (the
// callers set its results to NaN from info).
//
// What bounds it on this card: the tile products are ~all of the work.  At
// the main path's shape (W = 43 windows, Mp = 1280, K = Up + 1 = 961) the
// factorization is W Mp^3 / 3 = 30.1 GFLOP and the solve W Mp^2 K = 67.7
// GFLOP.  On the tensor cores in 3xTF32 (three TF32 products for each f32
// one, below) that is 293 GFLOP at 495 TFLOP/s: 0.593 ms; at the f32 rate
// outside the tensor cores 1.459 ms.  The bytes (B11's lower triangle and
// the right-hand side read, Y written, ~0.56 GB) take ~0.17 ms at 3.35 TB/s.
//
// What the design does about it:
//  * one persistent launch a slab.  The work is cut into 64 x 64 tile
//    tasks: diagonal (w, j), L_jj = chol(A_jj - L_j,<j L_j,<j^T); panel
//    (w, i, j), i > j, L_ij = (A_ij - L_i,<j L_j,<j^T) L_jj^-T; solve
//    (w, x, j) for 64-column tile x of Y, Y_j = L_jj^-1 (R_j - L_j,<j
//    Y_<j).  Blocks take tasks from a global counter in a topological order
//    (decode): diag (w, 0), then for each step j the panel (w, j + 1, j) and
//    diag (w, j + 1) of the critical chain first, the other panels of step
//    j, the solves of step j - 1; the solves of the last step at the end.
//    Each task waits on per-window progress counters in global memory:
//    rows[w][i], the block columns of L's block row i written, and
//    cols[w][x], the row blocks of Y's column tile x written.  A task waits
//    only on tasks handed out before it, each held by a block that is
//    running, so the order cannot deadlock and no cooperative launch is
//    needed;
//  * the waits are per 64-k block of a product, so a task streams the
//    blocks that are ready: diag (w, j + 1) does all but the last 64 k of
//    its product while panel (w, j + 1, j), the step before it on the
//    chain, is still running, and a panel its whole product before it
//    waits for L_jj (look-ahead on the critical diagonal chain);
//  * the products run on the tensor cores: wgmma m64n64k8 tf32, both
//    operands K-major as TF32 wgmma requires (L's rows along k, Y's columns
//    along its rows).  Operands arrive by TMA (3-D maps over [W, rows, k],
//    boxes of 64 rows x 32 k = 128 bytes, 128-byte swizzle, zero fill past
//    K) into a 3-stage ring on mbarriers, one producer warp issuing (a
//    diagonal task's two operands are one box).  3xTF32, as accurate as
//    f32 products: A goes to registers (register-A wgmma) split into hi =
//    tf32(x) and lo = tf32(x - hi); B is split in its landed box, hi over
//    x and lo beside it; lo hi + hi lo + hi hi are summed in f32 (hi hi
//    alone under the caller's TF32 switch).  With A in registers wgmma
//    reads only B from shared memory: a chunk costs the port 72 KB,
//    against 112 KB with both operands split there, which ran slower on
//    the H100.  Each chunk's wgmmas retire before the next is split: a
//    second set of A fragments in flight spills at 2 blocks an SM;
//  * accuracy: the running tile starts as the input tile, and each 64 k of
//    products is summed in a fresh accumulator and taken off it with
//    Kahan's compensation, which keeps the kernel within ~1.5x of the
//    library pair's distance from a float64 solve (PERF.md);
//  * the in-tile steps (64 x 64, once a task) stage the tile through shared
//    memory, over the spent ring, into 8 rows x 4 columns a thread: the
//    substitutions (the solve's, and the panel's posed as L_jj L_ij^T =
//    C^T) by blocks of 8 rows, 8 barriers a tile; the factorization pivot
//    by pivot, one barrier a pivot.  One reciprocal square root per pivot,
//    correctly rounded (__frsqrt_rn, __frcp_rn), and LAPACK's scaling by it;
//  * ordering across blocks: a tile's writers store, fence the async proxy
//    and the device, meet at a barrier, and one of them raises the counter
//    (atomicMax); the reader spins on an acquire load, fences the async
//    proxy before its TMA load, and reads what it stages itself past L1;
//  * a failed diagonal sets info and raises every counter of its window to
//    kFail, so that the window's waiting tasks wake; tasks of a window
//    found failed when they are taken do nothing.  Results do not depend
//    on which block runs which task, nor on W: every tile's sums run in one
//    order.
//
// Where its time goes (profile_solve.py on the H100, main path's shape;
// PERF.md): a task's phases run one after another in its block (2 blocks
// an SM); the products are ~2/3 of a block's time and the fixed phases
// (the input tile's loads, the in-tile step, the stores and the release)
// ~1/3.  L2 traffic is not the limit (the same loads from one L2-resident
// box take as long), the L1 cache is (the most shared memory carved out
// of it costs ~5%), so the ring stays at 3 stages and no tile is
// prefetched into shared memory (both measured slower).

#include <climits>
#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kT = 64;                  // tile side
constexpr int kKc = 32;                 // k of one chunk: a 128-byte box row
constexpr int kStages = 3;              // ring stages
constexpr int kThreads = 128 + 32;      // a consumer warpgroup, a producer
constexpr int kBox = kT * kKc * 4;      // one operand's chunk, bytes
constexpr int kStage = 3 * kBox;        // A, B, B's lo
constexpr int kRing = kStages * kStage;
// dynamic shared memory: 1024-byte alignment slack, the ring, the full and
// empty barriers, the task slot
constexpr int kSmem = 1024 + kRing + 2 * kStages * 8 + 16;
constexpr int kSt = kT + 4;             // row stride of staged tiles
constexpr int kSp = kT + 1;             // row stride of the pivot columns
// the in-tile buffers (floats), over the ring once a task's chunks are
// spent: L_jj, the finished tile, the running tile (the pivot columns
// once it is in registers), the pivots' reciprocals and square roots
constexpr int kLs = 0, kXs = kLs + kT * kSt, kStg = kXs + kT * kSt;
constexpr int kCol = kStg, kRq = kStg + kT * kSt, kLq = kRq + kT;
static_assert(kT * kSp <= kT * kSt, "the pivot columns fit the tile");
static_assert((kLq + kT) * 4 <= kRing, "in-tile buffers fit the ring");
constexpr int kFail = 1 << 30;          // a failed window's counters

// the consumer warpgroup's barrier (the producer warp is not in it)
__device__ __forceinline__ void csync() { named_sync(1, 128); }

using Tile = float[8][4];
using Frag = float[32];

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
    csync();
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
      csync();
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
  csync();
  return 0;
}

// A tile task: kind 0 diagonal (w, j), 1 panel (w, i, j), 2 solve of
// column tile x (w, x, j); -1 past the end.
struct Task {
  int kind, w, i, j, x;
};

// Task t of the topological order (see the header): W diagonals of step 0,
// then for each step j the panels (w, j + 1, j) and diagonals (w, j + 1)
// of the chain, the panels (w, i, j) for i > j + 1 (by i, then w), the
// solves (w, x, j - 1) (by x, then w); the solves of the last step close.
__device__ __forceinline__ Task decode(int t, int W, int nb, int nx) {
  if (t < W) return Task{0, t, 0, 0, 0};
  t -= W;
  for (int j = 0; j <= nb; ++j) {
    const int lead = j + 1 < nb ? W : 0;
    if (t < lead) return Task{1, t, j + 1, j, 0};
    t -= lead;
    if (t < lead) return Task{0, t, j + 1, j + 1, 0};
    t -= lead;
    const int np = j + 2 < nb ? (nb - 2 - j) * W : 0;
    if (t < np) return Task{1, t % W, j + 2 + t / W, j, 0};
    t -= np;
    const int ns = j > 0 ? nx * W : 0;
    if (t < ns) return Task{2, t % W, j - 1, j - 1, t / W};
    t -= ns;
  }
  return Task{-1, 0, 0, 0, 0};
}

// Waits until *p > v and returns what it read.  A counter that never moves
// is a fault: trap after ~10 s rather than hang the card.
__device__ __forceinline__ int wait_above(const int* p, int v) {
  int got = ld_acquire(p);
  if (got > v) return got;
  const long long t0 = clock64();
  while ((got = ld_acquire(p)) <= v) {
    __nanosleep(128);
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
  return got;
}

// Raises *p to v once every consumer thread's stores of the tile are
// visible to other blocks, their TMA loads included.
__device__ __forceinline__ void publish(int* p, int v) {
  fence_proxy_async_global();
  csync();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicMax(p, v);
  }
}

// Accumulator layout of m64n64 (warp q of the warpgroup): rows 16 q +
// lane / 4 in registers 4 c, 4 c + 1 and that + 8 in 4 c + 2, 4 c + 3;
// columns 8 c + 2 (lane % 4) + {0, 1}.  at(r, col) gives the element.
template <class F>
__device__ __forceinline__ void frag_load(Frag& P, F at) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * (threadIdx.x >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int h = 0; h < 4; ++h)
      P[4 * c + h] = at(r + 8 * (h >> 1), 8 * c + c0 + (h & 1));
}

// The fragment into t [64][kSt], row-major.
__device__ __forceinline__ void frag_store(const Frag& P, float* t) {
  const int lane = threadIdx.x & 31;
  const int r = 16 * (threadIdx.x >> 5) + (lane >> 2), c0 = 2 * (lane & 3);
#pragma unroll
  for (int c = 0; c < 8; ++c)
#pragma unroll
    for (int h = 0; h < 4; h += 2)
      *reinterpret_cast<float2*>(t + (r + 4 * h) * kSt + 8 * c + c0) =
          make_float2(P[4 * c + h], P[4 * c + h + 1]);
}

// B's landed box in place: hi = tf32(x) over x and, with kX3, lo =
// tf32(x - hi) into ``lo``.  Elementwise, so the swizzle does not matter:
// both boxes share it.  (Taking the box as its own hi, truncated by the
// tensor cores, saves the hi write but put the solve 1.57x the library
// pair's distance from float64 on the H100, against 1.16x rounded.)
template <bool kX3>
__device__ __forceinline__ void split_b(uint8_t* box, uint8_t* lo) {
  float4* x = reinterpret_cast<float4*>(box);
  float4* l = reinterpret_cast<float4*>(lo);
#pragma unroll
  for (int p = 0; p < kBox / 16 / 128; ++p) {
    const int idx = threadIdx.x + 128 * p;
    const float4 v = x[idx];
    const float4 h = make_float4(tf32_round(v.x), tf32_round(v.y),
                                 tf32_round(v.z), tf32_round(v.w));
    x[idx] = h;
    if constexpr (kX3)
      l[idx] = make_float4(tf32_round(v.x - h.x), tf32_round(v.y - h.y),
                           tf32_round(v.z - h.z), tf32_round(v.w - h.w));
  }
}

// A's register fragments (wgmma_tf32_rs) for the four k8 steps of its
// landed box (64 rows x 32 k, 128-byte swizzle: 16-byte chunk c of row r
// at chunk c ^ (r % 8)), split into hi = tf32(x) and, with kX3, lo =
// tf32(x - hi).  Conflict-free: a warp's 32 loads of one register hit 8
// rows at 8 distinct chunks.
template <bool kX3>
__device__ __forceinline__ void load_a(const uint8_t* box,
                                       uint32_t (&hi)[16],
                                       uint32_t (&lo)[16]) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const float* a = reinterpret_cast<const float*>(box) +
                   (16 * (threadIdx.x >> 5) + g) * kKc + (lane & 3);
#pragma unroll
  for (int kk = 0; kk < kKc / 8; ++kk)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 2 * kk + (q >> 1);
      const float x = a[8 * (q & 1) * kKc + ((c ^ g) << 2)];
      const float h = tf32_round(x);
      hi[4 * kk + q] = __float_as_uint(h);
      if constexpr (kX3) lo[4 * kk + q] = __float_as_uint(tf32_round(x - h));
    }
}

// Keeps a fragment's registers from being reused before the wgmmas that
// read them have retired (the caller's wgmma_wait comes first).
__device__ __forceinline__ void keep(uint32_t (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(f[i]) :: "memory");
}

// Q (+)= A B^T over one chunk (32 k): A's fragments, B's box at shared
// address b and its lo box at lo.  ``first`` overwrites Q (the start of
// a 64-k block).  3xTF32: A lo B hi + A hi B lo + A hi B hi.
template <bool kX3>
__device__ __forceinline__ void chunk_products(Frag& Q,
                                               const uint32_t (&ah)[16],
                                               const uint32_t (&al)[16],
                                               uint32_t b, uint32_t lo,
                                               int first) {
  const uint64_t bh = smem_desc(b), bl = smem_desc(lo);
#pragma unroll
  for (int kk = 0; kk < kKc / 8; ++kk) {
    const int sc = (first && kk == 0) ? 0 : 1, f = 4 * kk;
    if constexpr (kX3) {
      wgmma_tf32_rs(Q, al[f], al[f + 1], al[f + 2], al[f + 3], bh + 2 * kk,
                    sc);
      wgmma_tf32_rs(Q, ah[f], ah[f + 1], ah[f + 2], ah[f + 3], bl + 2 * kk,
                    1);
      wgmma_tf32_rs(Q, ah[f], ah[f + 1], ah[f + 2], ah[f + 3], bh + 2 * kk,
                    1);
    } else {
      wgmma_tf32_rs(Q, ah[f], ah[f + 1], ah[f + 2], ah[f + 3], bh + 2 * kk,
                    sc);
    }
  }
}

template <bool kX3>
__global__ void __launch_bounds__(kThreads, 2)
chol_solve_kernel(const __grid_constant__ CUtensorMap mapL,
                  const __grid_constant__ CUtensorMap mapY, float* A,
                  float* Y, int* flags, int W, int Mp, int K, int want_l,
                  int total) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRing);
  uint64_t* empty = full + kStages;
  int* slot = reinterpret_cast<int*>(empty + kStages);   // task, failed
  float* sm = reinterpret_cast<float*>(ring);
  const int nb = Mp / kT, nx = (K + kT - 1) / kT;
  int* info = flags;
  int* rows = info + W;                 // [W][nb]
  int* cols = rows + W * nb;            // [W][nx]
  int* counter = cols + W * nx;
  const int warp = __shfl_sync(0xffffffff, (int)threadIdx.x / 32, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int t = atomicAdd(counter, 1);
    slot[0] = t;
    slot[1] = t < total ? ld_acquire(info + decode(t, W, nb, nx).w) : 0;
  }
  uint32_t gc = 0;                      // chunks through the ring so far
  for (;;) {
    __syncthreads();                    // the slot holds this task
    const int t = __shfl_sync(0xffffffff, slot[0], 0);
    const int failed = __shfl_sync(0xffffffff, slot[1], 0);
    __syncthreads();                    // everyone has read it
    if (t >= total) break;
    const Task k = decode(t, W, nb, nx);
    const int w = k.w, i = k.i, j = k.j;
    const bool same = k.kind == 0;      // a diagonal's operands are one box
    const int n = failed ? 0 : 2 * j;   // chunks of 32 k
    float* Aw = A + (int64_t)w * Mp * Mp;

    if (warp == 4) {                    // producer warp: one thread issues
      if (lane == 0) {
        const int nxt = atomicAdd(counter, 1);
        const int* pa = rows + w * nb + j;                // L's block row j
        const int* pb = k.kind == 1 ? rows + w * nb + i   // L's block row i
                      : k.kind == 2 ? cols + w * nx + k.x // Y's column tile
                                    : pa;
        int seen_a = 0, seen_b = 0;
        for (int c = 0; c < n; ++c) {
          const uint32_t s = gc % kStages, round = gc / kStages;
          ++gc;
          if ((c & 1) == 0) {           // a new 64-k block: its tiles done
            const int kb = c >> 1;
            if (seen_a <= kb) seen_a = wait_above(pa, kb);
            if (seen_b <= kb) seen_b = wait_above(pb, kb);
            fence_proxy_async_global();
          }
          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);
          uint8_t* st = ring + s * kStage;
          mbar_expect_tx(&full[s], same ? kBox : 2 * kBox);
          tma_load_3d(st, &mapL, &full[s], c * kKc, j * kT, w);
          if (k.kind == 1)
            tma_load_3d(st + kBox, &mapL, &full[s], c * kKc, i * kT, w);
          else if (k.kind == 2)
            tma_load_3d(st + kBox, &mapY, &full[s], c * kKc, k.x * kT, w);
        }
        slot[0] = nxt;
        slot[1] = nxt < total ? ld_acquire(info + decode(nxt, W, nb, nx).w)
                              : 0;
      }
      continue;
    }
    if (failed) continue;

    // consumer warpgroup: the running tile P, its input to start with
    Frag P, C, Q;
    const int u0 = k.x * kT, valid = min(K - u0, kT);
    float* Yj = Y + (int64_t)w * K * Mp + (int64_t)u0 * Mp + j * kT;
    if (k.kind == 0) {
      const float* Ajj = Aw + (int64_t)j * kT * Mp + j * kT;
      frag_load(P, [&](int r, int c) { return __ldcg(Ajj + r * Mp + c); });
    } else if (k.kind == 1) {           // C^T: rows of block j, columns i
      const float* Aij = Aw + (int64_t)i * kT * Mp + j * kT;
      frag_load(P, [&](int r, int c) { return __ldcg(Aij + c * Mp + r); });
    } else {
      frag_load(P, [&](int r, int c) {
        return c < valid ? __ldcg(Yj + (int64_t)c * Mp + r) : 0.0f;
      });
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) C[e] = Q[e] = 0.0f;

    // P -= A B^T: A = L_j,<j; B = L_j,<j, L_i,<j or Y_<j's column tile.
    // Each 64 k (two chunks) is summed apart in Q and taken off P with a
    // compensation term (Kahan's), so the running value, which shrinks
    // towards the result (a pivot is small), keeps no error of its own
    // updates: without it the kernel was ~2x further from a float64
    // solve than the library pair on the main path's blocks.
    // One 64-k block an iteration, its two chunks unrolled, so that no
    // wgmma is in flight past an iteration (ptxas then needs no wait of
    // its own on a divergent path, which would serialize the wgmmas).
    for (int kb = 0; kb < n / 2; ++kb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t ah[16], al[16];
        const uint32_t s = gc % kStages, ph = (gc / kStages) & 1;
        ++gc;
        uint8_t* st = ring + s * kStage;
        uint8_t* bbox = same ? st : st + kBox;
        mbar_wait(&full[s], ph);
        load_a<kX3>(st, ah, al);
        if (same) csync();              // A's box is B's: read, then split
        split_b<kX3>(bbox, st + 2 * kBox);
        fence_proxy_async();            // the split, before wgmma reads it
        csync();
        fence_regs(Q);
        wgmma_fence();
        chunk_products<kX3>(Q, ah, al, smem_u32(bbox),
                            smem_u32(st + 2 * kBox), h == 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(Q);
        keep(ah);
        if constexpr (kX3) keep(al);
        if (threadIdx.x == 0) mbar_arrive(&empty[s]);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const float y = -Q[e] - C[e];
        const float tt = P[e] + y;
        C[e] = (tt - P[e]) - y;
        P[e] = tt;
      }
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) P[e] -= C[e];

    // the in-tile step on the spent ring
    float* Ls = sm + kLs;
    float* xs = sm + kXs;
    float* stg = sm + kStg;
    const int tc = threadIdx.x & 15, tr = threadIdx.x >> 4;
    frag_store(P, stg);
    if (k.kind != 0 && threadIdx.x == 0)
      wait_above(rows + w * nb + j, j); // L_jj written
    csync();
    Tile D;
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        D[r][e] = stg[(tr * 8 + r) * kSt + tc + 16 * e];
    float* Ljj = Aw + (int64_t)j * kT * Mp + j * kT;
    if (k.kind == 0) {
      float* col = sm + kCol;
      float* rq = sm + kRq;
      float* lq = sm + kLq;
      csync();                          // col is over the staged tile
      const int bad = factor_tile(D, col, lq, rq);
      if (bad) {
        if (threadIdx.x == 0) {
          atomicCAS(info + w, 0, j * kT + bad);
          __threadfence();
          for (int r = 0; r < nb; ++r) atomicMax(rows + w * nb + r, kFail);
          for (int x = 0; x < nx; ++x) atomicMax(cols + w * nx + x, kFail);
        }
      } else {
        for (int idx = threadIdx.x; idx < kT * kT; idx += 128) {
          const int r = idx >> 6, c = idx & 63;
          Ls[r * kSt + c] =
              c < r ? col[c * kSp + r] * rq[c] : (c == r ? lq[c] : 0.0f);
        }
        csync();
#pragma unroll
        for (int p = 0; p < kT * kT / 4 / 128; ++p) {
          const int idx = threadIdx.x + p * 128, r = idx >> 4;
          const int c = (idx & 15) * 4;
          *reinterpret_cast<float4*>(Ljj + (int64_t)r * Mp + c) =
              *reinterpret_cast<const float4*>(Ls + r * kSt + c);
        }
        publish(rows + w * nb + j, j + 1);
      }
    } else {
      float* rq = sm + kRq;
#pragma unroll
      for (int p = 0; p < kT * kT / 4 / 128; ++p) {
        const int idx = threadIdx.x + p * 128, r = idx >> 4;
        const int c = (idx & 15) * 4;
        *reinterpret_cast<float4*>(Ls + r * kSt + c) = __ldcg(
            reinterpret_cast<const float4*>(Ljj + (int64_t)r * Mp + c));
      }
      csync();
      if (threadIdx.x < kT)
        rq[threadIdx.x] = __frcp_rn(Ls[threadIdx.x * kSt + threadIdx.x]);
      csync();
      left_solve(D, Ls, rq, xs);        // the finished tile's rows in xs
      if (k.kind == 1) {
        // L_ij out, coalesced along its rows; with want_l, zeros to (j, i)
        float* Lij = Aw + (int64_t)i * kT * Mp + j * kT;
        float* Lji = Aw + (int64_t)j * kT * Mp + i * kT;
#pragma unroll
        for (int p = 0; p < kT * kT / 4 / 128; ++p) {
          const int idx = threadIdx.x + p * 128, r = idx >> 4;
          const int c = (idx & 15) * 4;
          *reinterpret_cast<float4*>(Lij + (int64_t)r * Mp + c) =
              *reinterpret_cast<const float4*>(xs + r * kSt + c);
          if (want_l)
            *reinterpret_cast<float4*>(Lji + (int64_t)r * Mp + c) =
                make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        publish(rows + w * nb + i, j + 1);
      } else {
        // Y_j out over R_j, coalesced along the columns
#pragma unroll
        for (int p = 0; p < kT * kT / 4 / 128; ++p) {
          const int idx = threadIdx.x + p * 128, u = idx >> 4;
          const int m = (idx & 15) * 4;
          if (u < valid)
            *reinterpret_cast<float4*>(Yj + (int64_t)u * Mp + m) =
                *reinterpret_cast<const float4*>(xs + u * kSt + m);
        }
        publish(cols + w * nx + k.x, j + 1);
      }
    }
    fence_proxy_async();                // the next TMA loads land here
  }
}

template <bool kX3>
cudaError_t prepare(int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(
      chol_solve_kernel<kX3>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, chol_solve_kernel<kX3>, kThreads, kSmem);
}

template <bool kX3>
int chol_solve(const CUtensorMap& mapL, const CUtensorMap& mapY, float* A,
               float* Y, int* flags, int W, int Mp, int K, int want_l,
               int total, cudaStream_t st) {
  int per_sm = 0, dev = 0, sms = 0;
  cudaError_t e = prepare<kX3>(&per_sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int grid = (int)((long long)per_sm * sms < total
                             ? (long long)per_sm * sms : total);
  chol_solve_kernel<kX3><<<grid, kThreads, kSmem, st>>>(
      mapL, mapY, A, Y, flags, W, Mp, K, want_l, total);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a block, bytes; *blocks_per_sm the blocks an SM
// holds at once (both printed by chip_smoke.py).
extern "C" int gauss_chol_solve_smem(int* blocks_per_sm) {
  if (prepare<true>(blocks_per_sm) != cudaSuccess) *blocks_per_sm = -1;
  return kSmem;
}

// int32 entries of the flags buffer the wrapper zeroes for a call: info
// [W] first, then the progress counters and the task counter.
extern "C" int gauss_chol_solve_flags(int W, int Mp, int K) {
  return W * (1 + Mp / kT + (K + kT - 1) / kT) + 1;
}

// In place, per window w < W: L over A[w]'s lower triangle (A [W, Mp, Mp]
// row-major, its lower triangle read; want_l zeroes the strict upper
// triangle), Y = L^-1 rhs over Y [W, K, Mp] in memory (rhs column-major),
// info in the first W entries of ``flags`` (gauss_chol_solve_flags int32
// entries, zero on entry).  Mp a multiple of 64, K >= 1; A and Y 16-byte
// aligned.  One launch on ``stream``.
extern "C" int gauss_chol_solve(void* A, void* Y, void* flags, int W, int Mp,
                                int K, int want_l, int tf32, void* stream) {
  if (Mp % kT || K < 1) return (int)cudaErrorInvalidValue;
  if (W <= 0 || Mp == 0) return 0;
  const long long nb = Mp / kT, nx = (K + kT - 1) / kT;
  const long long total = W * (nb + nb * (nb - 1) / 2 + nb * nx);
  if (total >= INT_MAX / 2) return (int)cudaErrorInvalidValue;
  CUtensorMap mapL, mapY;
  if (!encode_3d(&mapL, A, Mp, Mp, W, 4LL * Mp, 4LL * Mp * Mp, kKc, kT,
                 CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_DATA_TYPE_FLOAT32)
      || !encode_3d(&mapY, Y, Mp, K, W, 4LL * Mp, 4LL * Mp * K, kKc, kT,
                    CU_TENSOR_MAP_SWIZZLE_128B,
                    CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return tf32 ? chol_solve<false>(mapL, mapY, (float*)A, (float*)Y,
                                  (int*)flags, W, Mp, K, want_l, (int)total,
                                  st)
              : chol_solve<true>(mapL, mapY, (float*)A, (float*)Y,
                                 (int*)flags, W, Mp, K, want_l, (int)total,
                                 st);
}

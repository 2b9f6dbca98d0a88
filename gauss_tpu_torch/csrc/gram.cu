// K1: fused per-population weighted int8 Gram, batched over windows.
//
//   out[w, i, j] = sum_k beta_k * sum_{s in segment k} X[x0[w] + i, s] * Y[y0[w] + j, s]
//
// Replaces gauss_tpu/ops/pallas_gram.py:weighted_gram_t1 (_make_kernel, with
// the tile_tables / pair_tables bookkeeping), the Pallas TPU kernel that
// carries an int32 accumulator in VMEM scratch across a sequential K grid
// axis and folds it into f32 at each population's last K tile.
//
// Inputs are shifted dosages in [-2, 2] (int8), so every per-segment sum is
// an exact int32 for any segment shorter than 2^29 columns; the only rounding
// is the f32 fold beta_k * float(acc) at each segment's end.
//
// What bounds it on this card: integer tensor-core work (2 * W * nx * ny * S
// ops, ~1e13 per region at the main path's shapes) and, with 64 x 64 output
// tiles, the L2/HBM stream of X and Y tiles: every block reads (64 + 64) * S
// bytes for 64 * 64 * S multiply-adds, 32 MACs per byte.
//
// What the design does about it:
//  * each block owns one 64 x 64 output tile of one window; the reduction over
//    the subject axis is a loop inside the block (blocks run in no order, so
//    nothing can be carried between them as the TPU grid did);
//  * the loop walks 64-column chunks, population segment after segment: an
//    int32 accumulator is reset at each segment's start and folded into the
//    f32 accumulator at its end (segments are padded to 64 columns with
//    zeros, which add exactly 0);
//  * the inner product is mma.sync.m16n8k32 s8 x s8 -> s32 (four warps, each
//    a 32 x 32 sub-tile), fed from padded shared memory without bank
//    conflicts; the next chunk's global loads are issued into registers
//    before the current chunk's MMAs, so their latency overlaps the math;
//  * symmetric mode (the mm block) returns at once from tiles strictly above
//    the diagonal; the caller mirrors the lower triangle (mirror_lower);
//  * band offsets x0/y0 are per-window ROW offsets (any row), read from device
//    memory; rows past the end of X / Y read as zeros.
//
// wgmma / TMA pipelines are later work; this kernel is the simple, exact one.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;        // output tile edge (rows of X and of Y)
constexpr int kChunk = 64;       // subject columns (bytes) per K step
constexpr int kWords = kChunk / 4;
constexpr int kPad = kWords + 4; // shared row stride in 32-bit words
constexpr int kThreads = 128;    // four warps, 2 x 2 over the tile
constexpr int kMaxSegs = 64;

struct SegTable {
  int ends[kMaxSegs];            // cumulative segment ends, in chunks
  float beta[kMaxSegs];
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const int (&a)[4],
                                       const int (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One thread's two 16-byte pieces of a 64-row x 64-byte tile.
__device__ __forceinline__ void load_tile(int4 (&r)[2],
                                          const int8_t* __restrict__ base,
                                          int64_t row0, int64_t nrows,
                                          int64_t S, int64_t col) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int64_t row = row0 + (e >> 2);
    if (row < nrows) {
      r[i] = *reinterpret_cast<const int4*>(base + row * S + col +
                                            (e & 3) * 16);
    } else {
      r[i] = make_int4(0, 0, 0, 0);
    }
  }
}

__device__ __forceinline__ void store_tile(int (*sm)[kPad], const int4 (&r)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = threadIdx.x + i * kThreads;
    *reinterpret_cast<int4*>(&sm[e >> 2][(e & 3) * 4]) = r[i];
  }
}

__global__ void __launch_bounds__(kThreads)
weighted_gram_kernel(const int8_t* __restrict__ X,
                     const int8_t* __restrict__ Y,
                     const int32_t* __restrict__ x0,
                     const int32_t* __restrict__ y0,
                     float* __restrict__ out,
                     int nx, int ny, int64_t S, int64_t RX, int64_t RY,
                     int nseg, SegTable tab, int sym) {
  const int bj = blockIdx.x, bi = blockIdx.y, w = blockIdx.z;
  if (sym && bj > bi) return;

  __shared__ __align__(16) int As[kTile][kPad];
  __shared__ __align__(16) int Bs[kTile][kPad];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  const int64_t xrow0 = (int64_t)x0[w] + (int64_t)bi * kTile;
  const int64_t yrow0 = (int64_t)y0[w] + (int64_t)bj * kTile;

  int iacc[2][4][4];
  float facc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        iacc[mt][nt][q] = 0;
        facc[mt][nt][q] = 0.f;
      }

  const int nchunks = tab.ends[nseg - 1];
  int4 ra[2], rb[2];
  load_tile(ra, X, xrow0, RX, S, 0);
  load_tile(rb, Y, yrow0, RY, S, 0);
  int seg = 0;
  for (int c = 0; c < nchunks; ++c) {
    store_tile(As, ra);
    store_tile(Bs, rb);
    __syncthreads();
    if (c + 1 < nchunks) {
      load_tile(ra, X, xrow0, RX, S, (int64_t)(c + 1) * kChunk);
      load_tile(rb, Y, yrow0, RY, S, (int64_t)(c + 1) * kChunk);
    }
#pragma unroll
    for (int ks = 0; ks < kWords / 8; ++ks) {
      const int k = ks * 8 + t;
      int a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm + mt * 16 + g;
        a[mt][0] = As[r][k];
        a[mt][1] = As[r + 8][k];
        a[mt][2] = As[r][k + 4];
        a[mt][3] = As[r + 8][k + 4];
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int r = wn + nt * 8 + g;
        b[nt][0] = Bs[r][k];
        b[nt][1] = Bs[r][k + 4];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_s8(iacc[mt][nt], a[mt], b[nt]);
    }
    if (c + 1 == tab.ends[seg]) {  // segment ends: fold exact int32 into f32
      const float beta = tab.beta[seg];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            facc[mt][nt][q] += beta * (float)iacc[mt][nt][q];
            iacc[mt][nt][q] = 0;
          }
      ++seg;
    }
    __syncthreads();
  }

  float* o = out + (int64_t)w * nx * ny;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int64_t row = (int64_t)bi * kTile + wm + mt * 16 + g;
      const int64_t col = (int64_t)bj * kTile + wn + nt * 8 + t * 2;
      *reinterpret_cast<float2*>(o + row * ny + col) =
          make_float2(facc[mt][nt][0], facc[mt][nt][1]);
      *reinterpret_cast<float2*>(o + (row + 8) * ny + col) =
          make_float2(facc[mt][nt][2], facc[mt][nt][3]);
    }
}

}  // namespace

// ends: cumulative segment ends in COLUMNS (multiples of 64); beta: f32 fold
// factors.  Both are host arrays, passed to the kernel by value.
extern "C" int gauss_weighted_gram_t1(const void* X, const void* Y,
                                      const void* x0, const void* y0,
                                      void* out, int W, int nx, int ny,
                                      long long S, long long RX, long long RY,
                                      int nseg, const int* ends,
                                      const float* beta, int sym,
                                      void* stream) {
  if (nseg < 1 || nseg > kMaxSegs || nx % kTile || ny % kTile ||
      S % kChunk || ends[nseg - 1] != S)
    return (int)cudaErrorInvalidValue;
  if (W <= 0 || nx == 0 || ny == 0) return 0;
  SegTable tab;
  for (int s = 0; s < nseg; ++s) {
    if (ends[s] % kChunk) return (int)cudaErrorInvalidValue;
    tab.ends[s] = ends[s] / kChunk;
    tab.beta[s] = beta[s];
  }
  dim3 grid(ny / kTile, nx / kTile, W);
  weighted_gram_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)X, (const int8_t*)Y, (const int32_t*)x0,
      (const int32_t*)y0, (float*)out, nx, ny, S, RX, RY, nseg, tab, sym);
  return (int)cudaGetLastError();
}

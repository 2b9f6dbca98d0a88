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
// What bounds it on this card: integer tensor-core work, 2 * W * nx * ny * S
// operations (the lower triangle in sym mode), against 1,979 dense int8 TOP/s;
// the bytes (each band read once, the output written once) take about half
// as long at the main path's shapes.  Below that bound the kernel is held
// back by how many bytes each SM must pull from L2 per multiply-add, and by
// how well the tensor cores are kept fed.
//
// What the design does about it:
//  * wgmma.mma_async m64n128k32 s8 x s8 -> s32, the only instruction that
//    reaches the card's int8 rate.  X [rows, S] and Y [rows, S] are K-major
//    already, which int8 wgmma requires: no transpose anywhere;
//  * one CTA owns a 128 x 128 output tile of one window (two consumer
//    warpgroups, 64 rows each): 64 multiply-adds per byte streamed from L2,
//    twice the 64 x 64 tiles of the mma.sync kernel this one replaced;
//  * two CTAs, a cluster, own neighbouring tiles of one tile row and share
//    its X tile: each loads one half of it by TMA multicast into both, so
//    each pulls 24 KB instead of 32 KB from L2 per K box (85 multiply-adds
//    per byte);
//  * operands arrive by TMA into a 6-stage ring of 128-byte K boxes with
//    128-byte swizzle (the layout wgmma reads without bank conflicts), each
//    stage's arrival signalled on an mbarrier; one producer warp keeps the
//    ring full while the consumers run wgmma, and each consumer frees a stage
//    in both CTAs of the pair with an mbarrier arrive once its wgmmas on it
//    have retired (one stage of wgmma stays in flight);
//  * one 2-D tensor map per operand over the whole [R, S] array: a window's
//    band is a row coordinate (x0[w] + tile row, any row), and TMA fills rows
//    past R with zeros, which is the "rows past the end read as zeros" rule;
//  * the per-population fold costs registers: every output element has an
//    int32 and an f32 accumulator (64 + 64 per thread).  The int32 one is
//    reset by wgmma's scale-d = 0 at a segment's first k-step and folded,
//    facc += beta_k * float(iacc), after wgmma.wait_group at its last;
//  * segments are padded to 64 columns (K_CHUNK), half a K box: the consumer
//    walks each box as two 64-column halves and folds between them when a
//    segment ends mid-box, so the subject layout is unchanged;
//  * sym mode (the mm block) launches only the pairs that hold lower-
//    triangle tiles (the caller mirrors with mirror_lower); a pair that
//    reaches above the diagonal computes the extra tile into the unspecified
//    upper triangle.  A partial tile (nx or ny = 64 mod 128) idles the
//    warpgroup whose rows are all past nx and masks the store of columns
//    past ny.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kBM = 128;                 // tile rows (X), two warpgroups of 64
constexpr int kBN = 128;                 // tile columns (Y)
constexpr int kBK = 128;                 // subject columns (bytes) per stage
constexpr int kChunk = 64;               // segment granularity (K_CHUNK)
constexpr int kStages = 6;
constexpr int kConsumers = 2;            // consumer warpgroups
constexpr int kThreads = kConsumers * 128 + 32;   // + one producer warp
constexpr int kStageA = kBM * kBK;
constexpr int kStageB = kBN * kBK;
constexpr int kSmem = kStages * (kStageA + kStageB) + 2 * kStages * 8 + 1024;
constexpr int kMaxSegs = 64;

struct SegTable {
  int ends[kMaxSegs];                    // cumulative segment ends, in chunks
  float beta[kMaxSegs];
};

__global__ void __launch_bounds__(kThreads, 1)
weighted_gram_kernel(__grid_constant__ const CUtensorMap tmX,
                     __grid_constant__ const CUtensorMap tmY,
                     const int32_t* __restrict__ x0,
                     const int32_t* __restrict__ y0,
                     float* __restrict__ out,
                     int nx, int ny, int nchunks, int nseg, SegTable tab,
                     int sym, int tiles_n2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sA = smem;
  uint8_t* sB = smem + kStages * kStageA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + kStages * kStageB);
  uint64_t* empty = full + kStages;

  // the pair (a cluster of 2 CTAs) owns tiles (bi, 2q) and (bi, 2q + 1):
  // row-major over the tile grid, or over the lower triangle, whose row bi
  // holds bi / 2 + 1 pairs (the last one may reach above the diagonal,
  // into the unspecified upper triangle, or past ny and store nothing)
  const int rank = blockIdx.x & 1, pair = blockIdx.x >> 1, w = blockIdx.y;
  int bi = 0, q = pair;
  if (sym) {
    while (q >= bi / 2 + 1) q -= bi++ / 2 + 1;
  } else {
    bi = pair / tiles_n2;
    q = pair % tiles_n2;
  }
  const int row0 = bi * kBM, col0 = (2 * q + rank) * kBN;
  // consumer warpgroups with rows inside nx (nx is a multiple of 64): the
  // same in both CTAs of the pair
  const int active = min(kConsumers, (nx - row0) / 64);
  const int nkb = (nchunks + 1) / 2;
  // warp-uniform for the compiler (a divergent-looking path around wgmma
  // makes ptxas serialize the wgmmas)
  const int warp = __shfl_sync(0xffffffff, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * active);  // consumers of both CTAs
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();                        // the peer's barriers exist

  if (warp == kConsumers * 4) {          // producer warp: one thread issues
    if (lane == 0) {
      // this CTA's half of the shared X tile goes to both CTAs, its own Y
      // tile to itself alone
      const int xr = x0[w] + row0 + rank * (kBM / 2), yr = y0[w] + col0;
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % kStages;
        if (kb >= kStages) mbar_wait(&empty[s], (kb / kStages - 1) & 1);
        mbar_expect_tx(&full[s], kStageA + kStageB);
        tma_load_multicast(sA + s * kStageA + rank * (kStageA / 2), &tmX,
                           &full[s], kb * kBK, xr, 0x3);
        tma_load(sB + s * kStageB, &tmY, &full[s], kb * kBK, yr);
      }
    }
  } else if (wg < active) {              // consumer warpgroups
    const uint32_t a_base = smem_u32(sA) + wg * 64 * kBK;
    const uint32_t b_base = smem_u32(sB);
    int iacc[64];
    float facc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      iacc[i] = 0;
      facc[i] = 0.f;
    }

    int seg = 0, seg_beg = 0, seg_end = tab.ends[0];
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % kStages;
      mbar_wait(&full[s], (kb / kStages) & 1);
      const uint64_t da = smem_desc(a_base + s * kStageA);
      const uint64_t db = smem_desc(b_base + s * kStageB);
#pragma unroll
      for (int h = 0; h < 2; ++h) {        // the box's two 64-column chunks
        // an odd nchunks leaves the last box's second chunk past S: TMA
        // filled it with zeros and it starts a "segment" never folded
        const int c = 2 * kb + h;
        fence_regs(iacc);
        wgmma_fence();
        wgmma_s8(iacc, da + 4 * h, db + 4 * h, c != seg_beg);
        wgmma_s8(iacc, da + 4 * h + 2, db + 4 * h + 2, 1);
        wgmma_commit();
        if (c + 1 == seg_end) {            // segment ends: fold exact int32
          wgmma_wait<0>();
          fence_regs(iacc);
          const float beta = tab.beta[seg];
#pragma unroll
          for (int i = 0; i < 64; ++i) facc[i] += beta * (float)iacc[i];
          ++seg;
          seg_beg = seg_end;
          seg_end = seg < nseg ? tab.ends[seg] : -1;
        }
      }
      // the previous stage's wgmmas have retired: hand its buffers back
      wgmma_wait<2>();
      if (kb > 0 && threadIdx.x % 128 == 0) {
        mbar_arrive_cluster(&empty[(kb - 1) % kStages], 0);
        mbar_arrive_cluster(&empty[(kb - 1) % kStages], 1);
      }
    }
    wgmma_wait<0>();

    // accumulator layout of m64nN: warp q of the warpgroup holds rows
    // 16q + lane/4 (+8); register 4j + {0,1} (+{2,3} for row + 8) holds
    // columns 8j + 2 (lane % 4) + {0, 1}
    float* o = out + (int64_t)w * nx * ny;
    const int r = row0 + wg * 64 + (warp % 4) * 16 + lane / 4;
    const int cb = col0 + (lane % 4) * 2;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = cb + 8 * j;
      if (col < ny) {
        *reinterpret_cast<float2*>(o + (int64_t)r * ny + col) =
            make_float2(facc[4 * j], facc[4 * j + 1]);
        *reinterpret_cast<float2*>(o + (int64_t)(r + 8) * ny + col) =
            make_float2(facc[4 * j + 2], facc[4 * j + 3]);
      }
    }
  }
  cluster_sync();                        // no CTA leaves while its peer may
                                         // still write into it
}

}  // namespace

// ends: cumulative segment ends in COLUMNS (multiples of 64); beta: f32 fold
// factors.  Both are host arrays, passed to the kernel by value.  X and Y
// must be 16-byte aligned with S a multiple of 64 (the wrapper checks).
extern "C" int gauss_weighted_gram_t1(const void* X, const void* Y,
                                      const void* x0, const void* y0,
                                      void* out, int W, int nx, int ny,
                                      long long S, long long RX, long long RY,
                                      int nseg, const int* ends,
                                      const float* beta, int sym,
                                      void* stream) {
  if (nseg < 1 || nseg > kMaxSegs || nx % 64 || ny % 64 || S % kChunk ||
      ends[nseg - 1] != S || (sym && nx != ny))
    return (int)cudaErrorInvalidValue;
  if (W <= 0 || nx == 0 || ny == 0) return 0;
  SegTable tab;
  for (int s = 0; s < nseg; ++s) {
    if (ends[s] % kChunk) return (int)cudaErrorInvalidValue;
    tab.ends[s] = ends[s] / kChunk;
    tab.beta[s] = beta[s];
  }
  CUtensorMap tmX, tmY;
  // each CTA of a pair loads half of the shared X tile
  if (!encode(&tmX, X, RX, S, kBK, kBM / 2, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&tmY, Y, RY, S, kBK, kBN, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const int tiles_m = (nx + kBM - 1) / kBM;
  const int pairs_n = ((ny + kBN - 1) / kBN + 1) / 2;   // tile pairs per row
  int pairs = tiles_m * pairs_n;
  if (sym) {
    pairs = 0;
    for (int bi = 0; bi < tiles_m; ++bi) pairs += bi / 2 + 1;
  }
  cudaError_t e = cudaFuncSetAttribute(
      weighted_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * pairs, W);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, weighted_gram_kernel, tmX, tmY,
                         (const int32_t*)x0, (const int32_t*)y0, (float*)out,
                         nx, ny, (int)(S / kChunk), nseg, tab, sym, pairs_n);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// dynamic shared memory of one CTA, bytes (printed by chip_smoke.py)
extern "C" int gauss_weighted_gram_smem() { return kSmem; }

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

// Wait until the phase of the given parity has completed.  A phase that
// never completes is a fault (a lost copy or arrival): trap after ~10 s
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

// Arrive on the barrier at the same shared-memory offset in CTA ``cta`` of
// the cluster.  Default (CTA-scope release) semantics, as CUTLASS's cluster
// pipelines use: with .release.cluster here and .acquire.cluster on the
// producer's wait the kernel ran ~3x slower.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n"
      :: "r"(smem_u32(bar)), "r"(cta) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// The box lands at the same offset in the shared memory of every CTA in
// ``mask`` and completes bytes on each one's barrier at ``bar``'s offset.
__device__ __forceinline__ void tma_load_multicast(void* dst,
                                                   const CUtensorMap* map,
                                                   uint64_t* bar, int col,
                                                   int row, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(row), "h"(mask)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile with 128-byte swizzle:
// 8-row x 128-byte atoms, 1024 bytes apart (SBO); the leading offset is
// unused for this layout.  The atom base must be 1024-byte aligned; a
// k-step inside the atom adds its byte offset / 16.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(1024 >> 4) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries.
__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (+)= A[64 x 32] * B[128 x 32]^T, both K-major in shared memory;
// scale_d == 0 overwrites d instead of accumulating.
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: reached through the runtime's
// entry-point query, so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [rows, S] int8, row-major: boxes of kBK columns x box_rows rows, 128-byte
// swizzle, zero fill out of bounds.
bool encode(CUtensorMap* map, const void* base, long long rows, long long S,
            int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || rows <= 0) return false;
  cuuint64_t dims[2] = {(cuuint64_t)S, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)S};
  cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  if (!encode(&tmX, X, RX, S, kBM / 2) || !encode(&tmY, Y, RY, S, kBN))
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

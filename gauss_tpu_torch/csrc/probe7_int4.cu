// K3 and K4: the two kernels of the int4 / on-chip-capacity probe.
//
// K3, int4 dot, replaces probes/probe7_int4.py:g (its pl.pallas_call): an
// exact int32 product C = A B^T of two int8 matrices cast to int4.
//
//   * Storage.  Operands are packed two's-complement nibbles, element 2j in
//     the low nibble of byte j, rows padded with zeros to a multiple of 16
//     bytes (the tensor map's row stride): half the bytes of K1's int8
//     bands in HBM, in L2 and in the TMA ring.  The packing pass is a kernel
//     of its own (pack_int4_kernel) that the wrapper launches.
//   * Arithmetic.  Hopper's wgmma takes no 4-bit operand, and the 4-bit
//     mma.sync that PTX still lists runs as s8 IMMA with the nibbles widened
//     in registers around every instruction (~2% of the int8 peak, measured
//     on the H100).  So the nibbles are widened to s8 on the chip, once per
//     K box, and multiplied by wgmma.mma_async m64n128k32 s32.s8.s8.
//   * Bound: operations, 2 M N K over the int8 tensor peak (no dense int4
//     rate is published for the H100).  Below it the kernel is held back by
//     its feed: at K1's yardstick shape the TMA ring, the widening and the
//     barriers alone, with no wgmma, took two thirds of the kernel's time
//     (PERF.md).
//
//   Design (K1's skeleton, gram.cu):
//   * a CTA owns a 128 x 128 output tile: two consumer warpgroups of 64
//     rows, one widening warpgroup, one TMA producer warp; pairs of tiles of
//     one tile row are 2-CTA clusters, each CTA loading half of the shared A
//     tile by TMA multicast;
//   * the ring holds packed K boxes of 128 bytes (256 int4 values) with
//     128-byte swizzle: 16 KB of A and 16 KB of B per stage, K1's stage
//     bytes for twice its values.  The tensor maps run over the packed
//     [rows, Kb] arrays; TMA zero-fills past Kb, M and N.  Boxes of 64-byte
//     rows fed the card half as fast: TMA moved about as many rows per
//     second as K1's 128-byte rows, and the product took 4.0 ms with no
//     wgmma at all (PERF.md);
//   * A is widened in registers: for each half of the box each consumer
//     thread reads 16 packed bytes of each of its two rows and builds its
//     wgmma register fragments, which feed wgmma's register-A form (integer
//     wgmma takes A from registers in K-major layout).  The halves alternate
//     between two fragment arrays, so no fragment that an unretired wgmma
//     reads is rewritten;
//   * B is widened once per box, by the widening warpgroup, into one of
//     three s8 tiles of two 128-byte-swizzled halves (the layout smem_desc
//     describes), which lets it run ahead of the wgmmas.  The writes go
//     through the generic proxy, so each thread fences them to the async
//     proxy before its warp arrives on the tile's mbarrier, and the
//     consumers wait on that barrier before any wgmma reads the tile; each
//     consumer warpgroup frees the tile on a second barrier once those
//     wgmmas have retired;
//   * every consumer and widening warp of both CTAs frees a packed stage as
//     soon as it holds its bytes in registers (one mbarrier arrival per warp
//     in each CTA), so the producers refill it while the wgmmas run;
//   * one group of wgmmas stays in flight per consumer (wait_group 1); the
//     first wgmma zeroes the accumulators (scale-d 0), so that no other
//     instruction writes them while wgmmas run (ptxas serializes the wgmmas
//     otherwise, C7515);
//   * int32 accumulators only (64 per thread): exact for any K below 2^25,
//     since |a b| <= 64.  Rows past M and columns past N are not stored.
//
//   The K order.  A dot product is the same in any order of K as long as
//   both operands use it.  A 32-bit word w of packed bytes holds 8 nibbles;
//   its low nibbles (w & 0x0F0F0F0F) and its high nibbles ((w >> 4) &
//   0x0F0F0F0F) are each four s8 bytes after the sign extension
//   x + (x & 0x08080808) * 0x1E, with no byte permute.  In a box, packed
//   byte 32 t + 4 s + i (t, i in 0..3, s in 0..7) holds values
//   2 (32 t + 4 s + i) and + 1; its low nibble goes to s8 position
//   32 s + 4 t + i and its high nibble to 32 s + 16 + 4 t + i: k-step s of
//   thread t's fragment is word s of its 32 bytes (a0/a1 its low plane,
//   a2/a3 its high plane).  With the 128-byte swizzle, the two rows that a
//   quarter-warp's 16-byte loads reach fall on distinct banks.
//   probes/probe7_int4.py:widen_int4_plain writes the same order.
//
// K4, resident row sums, replaces probes/probe7_int4.py:h (its
// pl.pallas_call): out[r, :] = sum_s x[r, s] in int32, broadcast to 128
// columns, over a block held whole in on-chip memory.  On the TPU that was
// VMEM; here it is the shared memory of the c CTAs of one thread-block
// cluster, which is what puts the whole block on chip at once.
//
//   * Each CTA holds its share of the rows (rows_per_cta, the last share
//     cut at R).  The lanes of warp 0 issue one cp.async.bulk per row, each
//     row on an mbarrier of its own, so a row is summed as soon as it lands.
//   * Warp w sums rows w, w + 8, ... of its own CTA's shared memory with
//     16-byte loads and dp4a, keeping the sum in registers; a shuffle
//     finishes it and the warp writes the 128-column broadcast as one
//     coalesced 512-byte store.  No block barrier in the row loop, no
//     access to another CTA's memory, no cluster barrier.
//   * int8: dp4a per word.  int4 (packed as above): the two nibble planes by
//     dp4a, minus 16 for each nibble with its sign bit set.
//   * Bound: bytes, the block read once and the [R, 128] int32 written once.
//     A cluster launch costs a few microseconds, far above that bound.
//   * gauss_resident_rowsum_fit answers, without launching, whether a block
//     of rows_per_cta rows per CTA fits: the opt-in shared-memory limit,
//     then cudaOccupancyMaxActiveClusters for clusters of c such CTAs.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

constexpr int kMaxDevices = 64;

// ---------------------------------------------------------------- packing

// out[r, j] = (x[r, 2j] & 15) | (x[r, 2j + 1] & 15) << 4, zero past K; one
// thread per 4 output bytes.  Kb (bytes per output row) is a multiple of 4.
__global__ void pack_int4_kernel(const int8_t* __restrict__ x,
                                 uint8_t* __restrict__ out, int64_t R,
                                 int64_t K, int64_t Kb) {
  const int64_t words = Kb / 4;
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                    threadIdx.x;
  if (i >= R * words) return;
  const int64_t r = i / words, k0 = (i - r * words) * 8;
  const int8_t* src = x + r * K;
  uint32_t e[8];
  if (K % 8 == 0 && k0 + 8 <= K) {
    const uint2 v = *reinterpret_cast<const uint2*>(src + k0);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] = (v.x >> (8 * j)) & 15u;
      e[4 + j] = (v.y >> (8 * j)) & 15u;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = k0 + j < K ? static_cast<uint32_t>(src[k0 + j]) & 15u : 0u;
  }
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) w |= e[j] << (4 * j);
  reinterpret_cast<uint32_t*>(out + r * Kb)[i - r * words] = w;
}

// ---------------------------------------------------------------- K3

constexpr int kBM = 128, kBN = 128;      // CTA tile
constexpr int kBox = 128;                // packed bytes per K box (256 values)
constexpr int kStages = 4;
constexpr int kWide = 3;                 // widened B tiles
constexpr int kConsumers = 2;            // consumer warpgroups
// consumer warpgroups, the widening warpgroup, the producer warp
constexpr int kDotThreads = kConsumers * 128 + 128 + 32;
constexpr int kWidenWarp = kConsumers * 4;
constexpr int kProducerWarp = kWidenWarp + 4;
constexpr int kStageA = kBM * kBox;
constexpr int kStageB = kBN * kBox;
constexpr int kHalf = kBN * 128;         // 128 s8 values of each B row
constexpr int kWideB = 2 * kHalf;        // a widened box: two halves
constexpr int kDotSmem = kWide * kWideB + kStages * (kStageA + kStageB) +
                         (2 * kStages + 2 * kWide) * 8 + 1024;
// arrivals that free a packed stage: every consumer and widening warp of
// both CTAs
constexpr int kStageUsers = 2 * (kConsumers * 4 + 4);

// byte offset of 16-byte chunk c of row r in a tile of 128-byte rows with
// 128-byte swizzle (TMA's and wgmma's layout; the tile 1024-byte aligned)
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// the low nibbles of w's four bytes, each sign-extended to s8: x +
// (x & 8) * 0x1E per byte (0xF0 added to a nibble whose sign bit is set;
// the two terms share no bit, so the sum is one multiply-add)
__device__ __forceinline__ uint32_t widen_lo(uint32_t w) {
  return (w & 0x0F0F0F0Fu) + (w & 0x08080808u) * 0x1Eu;
}

__device__ __forceinline__ uint32_t widen_hi(uint32_t w) {
  return widen_lo(w >> 4);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// One warp's arrival on a barrier of both CTAs of the pair, once all its
// lanes are done with what the barrier guards.
__device__ __forceinline__ void warp_arrive_pair(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) {
    mbar_arrive_cluster(bar, 0);
    mbar_arrive_cluster(bar, 1);
  }
}

__global__ void __launch_bounds__(kDotThreads, 1)
int4_dot_kernel(__grid_constant__ const CUtensorMap tmA,
                __grid_constant__ const CUtensorMap tmB,
                int32_t* __restrict__ C, int M, int N, int nkb,
                int pairs_n) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sW = smem;                    // widened B tiles, 1024-aligned
  uint8_t* sA = sW + kWide * kWideB;
  uint8_t* sB = sA + kStages * kStageA;
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + kStages * kStageB);
  uint64_t* empty = full + kStages;      // packed stage free (both CTAs)
  uint64_t* wfull = empty + kStages;     // widened tile written
  uint64_t* wempty = wfull + kWide;      // widened tile read by wgmma

  // the pair (a cluster of 2 CTAs) owns tiles (bi, 2q) and (bi, 2q + 1); the
  // second may lie past N and then stores nothing
  const int rank = blockIdx.x & 1, pair = blockIdx.x >> 1;
  const int bi = pair / pairs_n, q = pair % pairs_n;
  const int row0 = bi * kBM, col0 = (2 * q + rank) * kBN;
  // warp-uniform for the compiler (a divergent-looking path around wgmma
  // makes ptxas serialize the wgmmas)
  const int warp = __shfl_sync(0xffffffff, threadIdx.x / 32, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kStageUsers);
    }
    for (int w = 0; w < kWide; ++w) {
      mbar_init(&wfull[w], 4);           // the widening warps
      mbar_init(&wempty[w], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();                        // the peer's barriers exist

  if (warp == kProducerWarp) {           // producer warp: one thread issues
    if (lane == 0) {
      const int ar = row0 + rank * (kBM / 2);
      for (int kb = 0; kb < nkb; ++kb) {
        const int s = kb % kStages;
        if (kb >= kStages) mbar_wait(&empty[s], (kb / kStages - 1) & 1);
        mbar_expect_tx(&full[s], kStageA + kStageB);
        tma_load_multicast(sA + s * kStageA + rank * (kStageA / 2), &tmA,
                           &full[s], kb * kBox, ar, 0x3);
        tma_load(sB + s * kStageB, &tmB, &full[s], kb * kBox, col0);
      }
    }
  } else if (warp >= kWidenWarp) {       // the widening warpgroup
    // 512 units of packed B per box, four per thread: row n's bytes
    // 32 t .. 32 t + 31, chunks 2 t and 2 t + 1.  Word ks of chunk 2 t + h
    // is k-step 4 h + ks (see "The K order"): its low and high planes go to
    // chunks 2 ks and 2 ks + 1 of row n of half h of the widened tile
    const int wtid = threadIdx.x - kWidenWarp * 32;   // 0..127
    for (int kb = 0; kb < nkb; ++kb) {
      const int s = kb % kStages, wi = kb % kWide;
      if (kb >= kWide) mbar_wait(&wempty[wi], (kb / kWide - 1) & 1);
      mbar_wait(&full[s], (kb / kStages) & 1);
      const uint8_t* pb = sB + s * kStageB;
      uint8_t* wb = sW + wi * kWideB;
      uint4 v[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = wtid + 128 * j, n = u >> 2, t = u & 3;
        v[j][0] = *reinterpret_cast<const uint4*>(pb + swz(n, 2 * t));
        v[j][1] = *reinterpret_cast<const uint4*>(pb + swz(n, 2 * t + 1));
      }
      warp_arrive_pair(&empty[s], lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int u = wtid + 128 * j, n = u >> 2, t = u & 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint8_t* half = wb + h * kHalf + 4 * t;
#pragma unroll
          for (int ks = 0; ks < 4; ++ks) {
            const uint32_t w = word(v[j][h], ks);
            *reinterpret_cast<uint32_t*>(half + swz(n, 2 * ks)) =
                widen_lo(w);
            *reinterpret_cast<uint32_t*>(half + swz(n, 2 * ks + 1)) =
                widen_hi(w);
          }
        }
      }
      // the writes reach wgmma (the async proxy) before the arrival
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&wfull[wi]);
    }
  } else {                               // consumer warpgroups
    const int wg = warp / 4, g = lane / 4, t = lane % 4;
    const int ar = wg * 64 + (warp % 4) * 16 + g;   // A rows ar, ar + 8
    int acc[64];                         // the first wgmma overwrites it

    // half h of box kb: four k-steps, one group of wgmmas.  Its A
    // fragments go to ``af``, which the group reads until it retires; the
    // halves alternate between two such arrays, so no fragment of the group
    // still in flight is written
    auto half = [&](int kb, int h, uint32_t (&af)[16]) {
      const int s = kb % kStages, wi = kb % kWide;
      if (h == 0) mbar_wait(&full[s], (kb / kStages) & 1);
      // A: this thread's two rows, the 16 bytes of its quarter in half h
      const uint8_t* pa = sA + s * kStageA;
      const uint4 x0 = *reinterpret_cast<const uint4*>(pa + swz(ar,
                                                                2 * t + h));
      const uint4 x1 = *reinterpret_cast<const uint4*>(pa + swz(ar + 8,
                                                                2 * t + h));
      if (h == 1) warp_arrive_pair(&empty[s], lane);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        af[4 * ks] = widen_lo(word(x0, ks));
        af[4 * ks + 1] = widen_lo(word(x1, ks));
        af[4 * ks + 2] = widen_hi(word(x0, ks));
        af[4 * ks + 3] = widen_hi(word(x1, ks));
      }
      // the fragments and descriptors are set before the fence: left to
      // the compiler, they are computed between the wgmmas and ptxas injects
      // a fence before each (C7519), which ran slower
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(af[i]));
      uint64_t db[4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        db[ks] = smem_desc(smem_u32(sW + wi * kWideB + h * kHalf)) + 2 * ks;
        asm volatile("" : "+l"(db[ks]));
      }
      if (h == 0) mbar_wait(&wfull[wi], (kb / kWide) & 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_s8_rs(acc, af[4 * ks], af[4 * ks + 1], af[4 * ks + 2],
                    af[4 * ks + 3], db[ks], kb + h + ks > 0);
      wgmma_commit();
      // the group before this one has retired: at h == 0 that is the
      // previous box's last, so its widened tile is free
      wgmma_wait<1>();
      if (h == 0 && kb > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&wempty[(kb - 1) % kWide]);
    };
    uint32_t af0[16], af1[16];
    for (int kb = 0; kb < nkb; ++kb) {
      half(kb, 0, af0);
      half(kb, 1, af1);
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // accumulator layout of m64nN: warp q of the warpgroup holds rows
    // 16q + lane/4 (+8); register 4j + {0,1} (+{2,3} for row + 8) holds
    // columns 8j + 2 (lane % 4) + {0, 1}
    const int r = row0 + ar;
    const int cb = col0 + 2 * t;
    const bool pairs = (N & 1) == 0;     // an int2 store stays aligned
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      if (row >= M) continue;
      int32_t* o = C + static_cast<int64_t>(row) * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = cb + 8 * j;
        const int v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (pairs && col + 1 < N) {
          *reinterpret_cast<int2*>(o + col) = make_int2(v0, v1);
        } else {
          if (col < N) o[col] = v0;
          if (col + 1 < N) o[col + 1] = v1;
        }
      }
    }
  }
  cluster_sync();                        // no CTA leaves while its peer may
                                         // still multicast into it
}

// ---------------------------------------------------------------- K4

constexpr int kSumThreads = 256;
constexpr int kSumWarps = kSumThreads / 32;

__device__ __forceinline__ int cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  return static_cast<int>(v);
}

__device__ __forceinline__ int word_sum(uint32_t w, bool nibbles) {
  if (!nibbles) return __dp4a(static_cast<int>(w), 0x01010101, 0);
  const int lo = __dp4a(static_cast<int>(w & 0x0F0F0F0Fu), 0x01010101, 0);
  const int hi = __dp4a(static_cast<int>((w >> 4) & 0x0F0F0F0Fu),
                        0x01010101, 0);
  return lo + hi - 16 * __popc(w & 0x88888888u);
}

__global__ void __launch_bounds__(kSumThreads)
resident_rowsum_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out,
                       int R, int row_bytes, int rows_per_cta,
                       int nibbles) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem + static_cast<int64_t>(rows_per_cta) * row_bytes);
  const int first = cluster_rank() * rows_per_cta;
  const int mine = max(0, min(R - first, rows_per_cta));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp == 0) {                       // one copy per row, one barrier each
    for (int r = lane; r < mine; r += 32) mbar_init(&bar[r], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const uint8_t* src = x + static_cast<int64_t>(first) * row_bytes;
    for (int r = lane; r < mine; r += 32) {
      mbar_expect_tx(&bar[r], row_bytes);
      bulk_load(smem + static_cast<int64_t>(r) * row_bytes,
                src + static_cast<int64_t>(r) * row_bytes, row_bytes, &bar[r]);
    }
  }
  __syncthreads();                       // the barriers exist

  const int chunks = row_bytes / 16;
  for (int r = warp; r < mine; r += kSumWarps) {
    mbar_wait(&bar[r], 0);
    const uint4* row = reinterpret_cast<const uint4*>(
        smem + static_cast<int64_t>(r) * row_bytes);
    int s = 0;
    for (int c = lane; c < chunks; c += 32) {
      const uint4 v = row[c];
      s += word_sum(v.x, nibbles) + word_sum(v.y, nibbles) +
           word_sum(v.z, nibbles) + word_sum(v.w, nibbles);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    reinterpret_cast<int4*>(out + static_cast<int64_t>(first + r) * 128)
        [lane] = make_int4(s, s, s, s);
  }
}

// The two function attributes K4's launch needs, set when they differ from
// the values last set on this device (not on every launch).
cudaError_t rowsum_attrs(int smem, int cluster) {
  static int set_smem[kMaxDevices], set_np[kMaxDevices];   // value + 1
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (set_smem[dev] != smem + 1) {
    e = cudaFuncSetAttribute(resident_rowsum_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    set_smem[dev] = smem + 1;
  }
  const int np = cluster > 8 ? 1 : 0;
  if (set_np[dev] != np + 1) {
    e = cudaFuncSetAttribute(resident_rowsum_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             np);
    if (e != cudaSuccess) return e;
    set_np[dev] = np + 1;
  }
  return cudaSuccess;
}

void rowsum_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                   int smem, int cluster, void* stream) {
  *cfg = {};
  cfg->gridDim = dim3(cluster);
  cfg->blockDim = dim3(kSumThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

// x: int8 [R, K] (row stride K); out: uint8 [R, Kb], Kb % 4 == 0 and
// Kb >= ceil(K / 2).
extern "C" int gauss_pack_int4(const void* x, void* out, long long R,
                               long long K, long long Kb, void* stream) {
  if (R < 0 || K < 0 || Kb % 4 || 2 * Kb < K) return (int)cudaErrorInvalidValue;
  const long long n = R * (Kb / 4);
  if (n == 0) return 0;
  const int threads = 256;
  pack_int4_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                     (cudaStream_t)stream>>>((const int8_t*)x, (uint8_t*)out,
                                             R, K, Kb);
  return (int)cudaGetLastError();
}

// A: packed [M, Kb], B: packed [N, Kb] (Kb % 16 == 0, 16-byte aligned
// bases); C: int32 [M, N].
extern "C" int gauss_int4_dot(const void* A, const void* B, void* C, int M,
                              int N, long long Kb, void* stream) {
  if (M < 0 || N < 0 || Kb <= 0 || Kb % 16 ||
      (reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(B)) % 16)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  CUtensorMap tmA, tmB;
  // each CTA of a pair loads half of the shared A tile
  if (!encode(&tmA, A, M, Kb, kBox, kBM / 2, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&tmB, B, N, Kb, kBox, kBN, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static bool attr_set[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    e = cudaFuncSetAttribute(int4_dot_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDotSmem);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  const int tiles_m = (M + kBM - 1) / kBM;
  const int pairs_n = ((N + kBN - 1) / kBN + 1) / 2;   // tile pairs per row
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * tiles_m * pairs_n);
  cfg.blockDim = dim3(kDotThreads);
  cfg.dynamicSmemBytes = kDotSmem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, int4_dot_kernel, tmA, tmB, (int32_t*)C, M, N,
                         (int)((Kb + kBox - 1) / kBox), pairs_n);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// dynamic shared memory of one K4 CTA holding rows_per_cta rows: the rows
// and one mbarrier per row
extern "C" int gauss_resident_rowsum_smem(int row_bytes, int rows_per_cta) {
  return rows_per_cta * (row_bytes + 8);
}

// Whether clusters of `cluster` CTAs of rows_per_cta rows each can run:
// *smem_optin gets the per-CTA opt-in limit, *clusters the number of such
// clusters the card can hold at once (0 when the shared memory does not fit).
extern "C" int gauss_resident_rowsum_fit(int row_bytes, int rows_per_cta,
                                         int cluster, int* smem_optin,
                                         int* clusters) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int smem = gauss_resident_rowsum_smem(row_bytes, rows_per_cta);
  *clusters = 0;
  if (smem > *smem_optin) return 0;
  if ((e = rowsum_attrs(smem, cluster)) != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  rowsum_config(&cfg, attr, smem, cluster, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, resident_rowsum_kernel,
                                             &cfg);
}

// x: [R, row_bytes] (int8 values, or packed int4 when int4 != 0), row_bytes
// % 16 == 0; out: int32 [R, 128].  One cluster of `cluster` CTAs.
extern "C" int gauss_resident_rowsum(const void* x, void* out, int R,
                                     int row_bytes, int int4, int cluster,
                                     void* stream) {
  if (R <= 0 || row_bytes <= 0 || row_bytes % 16 || cluster < 1 ||
      cluster > 16)
    return (int)cudaErrorInvalidValue;
  const int rows_per_cta = (R + cluster - 1) / cluster;
  const int smem = gauss_resident_rowsum_smem(row_bytes, rows_per_cta);
  cudaError_t e = rowsum_attrs(smem, cluster);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  rowsum_config(&cfg, attr, smem, cluster, stream);
  e = cudaLaunchKernelEx(&cfg, resident_rowsum_kernel, (const uint8_t*)x,
                         (int32_t*)out, R, row_bytes, rows_per_cta, int4);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

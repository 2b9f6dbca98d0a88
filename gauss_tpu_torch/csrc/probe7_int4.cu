// K3 and K4: the two kernels of the int4 / on-chip-capacity probe.
//
// K3, int4 dot, replaces probes/probe7_int4.py:g (its pl.pallas_call): an
// exact int32 product C = A B^T of two int8 matrices cast to int4.
//
//   * Storage.  Operands are packed two's-complement nibbles, element 2j in
//     the low nibble of byte j, rows padded with zeros to a multiple of 128
//     nibbles: half the bytes of K1's int8 bands.  The packing pass is a
//     kernel of its own (pack_int4_kernel) that the wrapper launches, so it
//     counts in the probe's time.
//   * Arithmetic.  Hopper's wgmma takes no 4-bit operand.  PTX still lists
//     mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 for sm_80 and later;
//     this kernel issues it, and whether ptxas for sm_90a takes it and at
//     what rate the card runs it is what the probe measures.  ptxas takes
//     it, but emits no 4-bit tensor-core instruction: the SASS holds
//     IMMA.16832.S8.S8, the nibbles widened to s8 in registers around it
//     (chip_smoke.py prints the count), and the kernel runs at ~2% of the
//     int8 peak (PERF.md).  Its fragments hold the same bytes as m16n8k32
//     s8's (32 bytes of K per row), so the tile loads are those of an int8
//     mma.sync kernel.
//   * Bound: operations, 2 M N K over the int8 tensor peak (no dense int4
//     rate is published for the H100).
//   * Design: 128 x 128 CTA tiles, four warps of 64 x 64, 128 nibbles of K
//     per stage, a 4-stage cp.async ring in shared memory (64 KB), 16-byte
//     chunks XOR-swizzled so that the warps' 32-bit fragment loads hit 32
//     distinct banks.  Rows past M or N load as zeros (cp.async src-size 0);
//     the epilogue masks the store.
//
// K4, resident row sums, replaces probes/probe7_int4.py:h (its
// pl.pallas_call): out[r, :] = sum_s x[r, s] in int32, broadcast to 128
// columns, over a block held whole in on-chip memory.  On the TPU that was
// VMEM (~16 MiB measured); here it is the shared memory of the c CTAs of
// one thread-block cluster.
//
//   * Each CTA stages its share of the rows (rows_per_cta, the last CTA's
//     share cut at R) with one cp.async.bulk per row on an mbarrier, then
//     the cluster synchronizes and each CTA sums the rows held in its
//     neighbour's (rank + 1 mod c) shared memory through distributed shared
//     memory (mapa, ld.shared::cluster.v4): every row is read from a CTA
//     other than the one that loaded it once c > 1.
//   * int8: dp4a per word.  int4 (packed as above): the two nibble planes by
//     dp4a, minus 16 for each nibble with its sign bit set.
//   * Bound: bytes, the block read once and the [R, 128] int32 written once.
//   * gauss_resident_rowsum_fit answers, without launching, whether a block
//     of rows_per_cta rows per CTA fits: the opt-in shared-memory limit,
//     then cudaOccupancyMaxActiveClusters for clusters of c such CTAs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 128;      // CTA tile
constexpr int kBK = 64;                  // bytes of K per stage (128 nibbles)
constexpr int kStages = 4;
constexpr int kDotThreads = 128;         // 2 x 2 warps of 64 x 64
constexpr int kStageBytes = (kBM + kBN) * kBK;
constexpr int kDotSmem = kStages * kStageBytes;

constexpr int kSumThreads = 256;
constexpr int kSumExtra = 64;            // mbarrier + per-warp partials

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// byte offset of 16-byte chunk c of tile row r: chunks XOR-swizzled by
// (r / 2) % 4, so rows 8 apart start on distinct bank groups
__device__ __forceinline__ int tile_off(int r, int c) {
  return r * kBK + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* tile, int r, int c,
                                          int t) {
  return *reinterpret_cast<const uint32_t*>(tile + tile_off(r, c) + 4 * t);
}

__device__ __forceinline__ void mma_s4(int32_t* d, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k64.row.col.s32.s4.s4.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kDotThreads)
int4_dot_kernel(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
                int32_t* __restrict__ C, int M, int N, int64_t Kb) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int bm = blockIdx.y * kBM, bn = blockIdx.x * kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 64, wn = (warp & 1) * 64;
  const int g = lane >> 2, t = lane & 3;
  const int KT = static_cast<int>(Kb / kBK);

  auto load = [&](int slot, int kt) {
    uint8_t* As = smem + slot * kStageBytes;
    uint8_t* Bs = As + kBM * kBK;
#pragma unroll
    for (int i = 0; i < kBM * kBK / 16 / kDotThreads; ++i) {
      const int id = tid + i * kDotThreads, r = id >> 2, c = id & 3;
      const int64_t off = static_cast<int64_t>(kt) * kBK + c * 16;
      const bool va = bm + r < M, vb = bn + r < N;
      cp_async16(smem_u32(As + tile_off(r, c)),
                 va ? A + (bm + r) * Kb + off : A, va);
      cp_async16(smem_u32(Bs + tile_off(r, c)),
                 vb ? B + (bn + r) * Kb + off : B, vb);
    }
  };

  int32_t acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < KT) load(s, s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int kt = 0; kt < KT; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2) : "memory");
    __syncthreads();          // stage kt landed; stage kt - 1 is free again
    if (kt + kStages - 1 < KT)
      load((kt + kStages - 1) % kStages, kt + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const uint8_t* As = smem + (kt % kStages) * kStageBytes;
    const uint8_t* Bs = As + kBM * kBK;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {     // two k64 steps of 32 bytes
      uint32_t a[4][4], b[8][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm + mi * 16 + g;
        a[mi][0] = lds32(As, r, 2 * kk, t);
        a[mi][1] = lds32(As, r + 8, 2 * kk, t);
        a[mi][2] = lds32(As, r, 2 * kk + 1, t);
        a[mi][3] = lds32(As, r + 8, 2 * kk + 1, t);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int r = wn + ni * 8 + g;
        b[ni][0] = lds32(Bs, r, 2 * kk, t);
        b[ni][1] = lds32(Bs, r, 2 * kk + 1, t);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
          mma_s4(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = bm + wm + mi * 16 + g + 8 * h;
        const int col = bn + wn + ni * 8 + 2 * t;
        if (row >= M) continue;
        int32_t* dst = C + static_cast<int64_t>(row) * N + col;
        if (col < N) dst[0] = acc[mi][ni][2 * h];
        if (col + 1 < N) dst[1] = acc[mi][ni][2 * h + 1];
      }
}

// ---------------------------------------------------------------- K4

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

// A phase that never completes is a fault: trap after ~10 s instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ int cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(v));
  return static_cast<int>(v);
}

__device__ __forceinline__ int cluster_size() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(v));
  return static_cast<int>(v);
}

__device__ __forceinline__ int word_sum(uint32_t w, bool int4) {
  if (!int4) return __dp4a(static_cast<int>(w), 0x01010101, 0);
  const int lo = __dp4a(static_cast<int>(w & 0x0F0F0F0Fu), 0x01010101, 0);
  const int hi = __dp4a(static_cast<int>((w >> 4) & 0x0F0F0F0Fu),
                        0x01010101, 0);
  return lo + hi - 16 * __popc(w & 0x88888888u);
}

__global__ void __launch_bounds__(kSumThreads)
resident_rowsum_kernel(const uint8_t* __restrict__ x, int32_t* __restrict__ out,
                       int R, int row_bytes, int rows_per_cta, int int4) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(
      smem + static_cast<int64_t>(rows_per_cta) * row_bytes);
  int* part = reinterpret_cast<int*>(bar + 1);
  const int rank = cluster_rank(), c = cluster_size();
  const int tid = threadIdx.x;
  auto rows_of = [&](int cta) {
    const int n = R - cta * rows_per_cta;
    return n < 0 ? 0 : (n < rows_per_cta ? n : rows_per_cta);
  };

  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_u32(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int mine = rows_of(rank);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(mine * row_bytes) : "memory");
    const uint8_t* src = x + static_cast<int64_t>(rank) * rows_per_cta *
                                 row_bytes;
    for (int r = 0; r < mine; ++r)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(smem + static_cast<int64_t>(r) * row_bytes)),
             "l"(src + static_cast<int64_t>(r) * row_bytes), "r"(row_bytes),
             "r"(smem_u32(bar))
          : "memory");
  }
  __syncthreads();                       // the barrier exists
  mbar_wait(bar, 0);                     // this CTA's rows have landed
  cluster_sync();                        // ... and every other CTA's

  const int nb = (rank + 1) % c;
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(smem)), "r"(nb));
  const int n_rows = rows_of(nb), chunks = row_bytes / 16;
  for (int r = 0; r < n_rows; ++r) {
    int s = 0;
    for (int ch = tid; ch < chunks; ch += kSumThreads) {
      uint32_t v0, v1, v2, v3;
      asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v0), "=r"(v1), "=r"(v2), "=r"(v3)
                   : "r"(remote + r * row_bytes + ch * 16) : "memory");
      s += word_sum(v0, int4) + word_sum(v1, int4) + word_sum(v2, int4) +
           word_sum(v3, int4);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((tid & 31) == 0) part[tid >> 5] = s;
    __syncthreads();
    if (tid < 128) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < kSumThreads / 32; ++w) total += part[w];
      out[(static_cast<int64_t>(nb) * rows_per_cta + r) * 128 + tid] = total;
    }
    __syncthreads();                     // part[] is reused by the next row
  }
  cluster_sync();                        // the neighbour is done reading us
}

cudaError_t rowsum_attrs(int smem, int cluster) {
  cudaError_t e = cudaFuncSetAttribute(
      resident_rowsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(resident_rowsum_kernel,
                              cudaFuncAttributeNonPortableClusterSizeAllowed,
                              cluster > 8 ? 1 : 0);
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

// A: packed [M, Kb], B: packed [N, Kb] (Kb % 64 == 0); C: int32 [M, N].
extern "C" int gauss_int4_dot(const void* A, const void* B, void* C, int M,
                              int N, long long Kb, void* stream) {
  if (M < 0 || N < 0 || Kb < 0 || Kb % kBK) return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      int4_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDotSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int4_dot_kernel<<<grid, kDotThreads, kDotSmem, (cudaStream_t)stream>>>(
      (const uint8_t*)A, (const uint8_t*)B, (int32_t*)C, M, N, Kb);
  return (int)cudaGetLastError();
}

// dynamic shared memory of one K4 CTA holding rows_per_cta rows
extern "C" int gauss_resident_rowsum_smem(int row_bytes, int rows_per_cta) {
  return rows_per_cta * row_bytes + kSumExtra;
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

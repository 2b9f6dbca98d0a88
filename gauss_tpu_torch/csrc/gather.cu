// K2: panel row gather, out[i] = G[idx[i]], with idx[i] < 0 giving a zero row.
//
// Replaces gauss_tpu/ops/dma_gather.py:gather_rows (_gather_kernel), the
// Pallas TPU kernel that keeps 128 per-row DMAs in flight.
//
// What bounds it on this card: pure data movement.  Every distinct panel
// row it names must be read once and every output row written once, so the
// floor is (distinct rows + N) * S bytes over HBM bandwidth.  On the main
// path (N = 96,320 rows of S = 34,176 B) the aligned batch names each
// measured row in two windows: 64,000 distinct rows among 89,000 real ids,
// ~5.5 GB of traffic per prepared batch.
//
// What the design does about it:
//  * output rows are taken in the order of their source rows (the wrapper
//    passes argsort(idx)), so the copies of a repeated row run back to back
//    and all but the first read it from L2;
//  * the copy is left to the bulk-copy engine, as the TPU kernel left it to
//    its DMA engines: each row is one piece of at most 36 KB (a wider row is
//    cut into equal pieces), and the one thread of a one-warp CTA per SM
//    runs its share of pieces (piece p, p + grid, ...) through a ring of 4
//    slots in shared memory, cp.async.bulk global -> shared (its arrival on
//    an mbarrier) and then cp.async.bulk shared -> global.  No registers or
//    load/store instructions per byte; two pieces of reads and up to two of
//    writes in flight per SM.
//
// Row offsets are 64-bit: row * S exceeds 2^31 at the main path's panel (64k
// rows x 34k columns).  The padding sentinel of prepare_resident_panel
// (window_kernel.py, "rows < 0 are padding") is folded in: a negative index
// stores a piece of zeros kept in shared memory instead of reading.  An
// index >= R is the caller's error; it is treated like a sentinel so that
// it never reads outside the panel.
//
// Requires S % 16 == 0 and 16-byte aligned base pointers (the wrapper checks;
// population segments are padded to 64 columns, so the port's panels always
// qualify).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPieceMax = 36864;         // bytes per bulk copy, at most
constexpr int kStages = 4;               // ring slots
constexpr int kAhead = 2;                // loads in flight
constexpr int kSmem = (kStages + 1) * kPieceMax + kStages * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// A phase that never completes is a fault: trap after ~10 s instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1LL << 34)) __trap();
}

struct Pieces {
  const int8_t* G;
  const int32_t* idx;
  const int64_t* order;                  // output rows in source-row order
  int8_t* out;
  int64_t S, R;
  int piece, per_row;

  // piece j of this CTA: source (nullptr for a sentinel row), destination
  // and length in bytes
  __device__ __forceinline__ void at(int64_t j, const int8_t*& src,
                                     int8_t*& dst, int& len) const {
    const int64_t p = blockIdx.x + j * gridDim.x;
    const int64_t k = p / per_row;
    const int64_t row = order[k];
    const int64_t off = (p - k * per_row) * piece;
    len = S - off < piece ? static_cast<int>(S - off) : piece;
    const int32_t r = idx[row];
    src = (r >= 0 && r < R) ? G + r * S + off : nullptr;
    dst = out + row * S + off;
  }
};

__global__ void __launch_bounds__(32)
gather_rows_kernel(Pieces pc, int64_t n_pieces) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* zero = smem + kStages * kPieceMax;
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + kPieceMax);

  // the zero piece is written by the threads (generic proxy) and read by
  // bulk stores (async proxy): fence, then sync, before any store
  for (int c = threadIdx.x; c < pc.piece / 16; c += 32)
    reinterpret_cast<int4*>(zero)[c] = make_int4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(smem_u32(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  if (threadIdx.x != 0) return;

  const int64_t mine =
      n_pieces > blockIdx.x ? (n_pieces - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  // fill the ring slot of piece j: a bulk load, or for a sentinel row a
  // bare arrival, so that every slot's phase turns once per use
  auto load = [&](int64_t j) {
    const int8_t* src;
    int8_t* dst;
    int len;
    pc.at(j, src, dst, len);
    const int s = static_cast<int>(j % kStages);
    const uint32_t bar = smem_u32(&full[s]);
    if (src != nullptr) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar), "r"(len) : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n"
          :: "r"(smem_u32(smem + s * kPieceMax)), "l"(src), "r"(len),
             "r"(bar)
          : "memory");
    } else {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                   :: "r"(bar) : "memory");
    }
  };
  for (int64_t j = 0; j < kAhead && j < mine; ++j) load(j);
  for (int64_t i = 0; i < mine; ++i) {
    if (i + kAhead < mine) {
      // the slot's last piece, i + kAhead - kStages, was stored before the
      // newest kStages - kAhead - 1 stores: that store must have read it
      asm volatile("cp.async.bulk.wait_group.read %0;\n"
                   :: "n"(kStages - kAhead - 1) : "memory");
      load(i + kAhead);
    }
    const int s = static_cast<int>(i % kStages);
    mbar_wait(&full[s], static_cast<int>((i / kStages) & 1));
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const int8_t* src;
    int8_t* dst;
    int len;
    pc.at(i, src, dst, len);
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        :: "l"(dst), "r"(smem_u32(src != nullptr ? smem + s * kPieceMax
                                                 : zero)),
           "r"(len)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// order: int64 [n], a permutation of the output rows sorting idx (device).
extern "C" int gauss_gather_rows(const void* G, const void* idx,
                                 const void* order, void* out, long long n,
                                 long long S, long long R, void* stream) {
  if (n <= 0) return 0;
  if (S <= 0 || S % 16) return (int)cudaErrorInvalidValue;
  const long long per_row0 = (S + kPieceMax - 1) / kPieceMax;
  const int piece = (int)(((S + per_row0 - 1) / per_row0 + 15) / 16 * 16);
  const int per_row = (int)((S + piece - 1) / piece);
  const long long n_pieces = n * per_row;
  cudaError_t e = cudaFuncSetAttribute(
      gather_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  static int per_sm = 0;                 // CTAs per SM: one kernel, one size
  int dev = 0, sms = 0;
  if (per_sm == 0 &&
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, gather_rows_kernel, 32, kSmem)) != cudaSuccess)
    return (int)e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  const long long cap = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned grid = (unsigned)(n_pieces < cap ? n_pieces : cap);
  Pieces pc{(const int8_t*)G, (const int32_t*)idx, (const int64_t*)order,
            (int8_t*)out, S, R, piece, per_row};
  gather_rows_kernel<<<grid, 32, kSmem, (cudaStream_t)stream>>>(pc, n_pieces);
  return (int)cudaGetLastError();
}

extern "C" const char* gauss_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

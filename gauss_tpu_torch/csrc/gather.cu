// K2: panel row gather, out[i] = G[idx[i]], with idx[i] < 0 giving a zero row.
//
// Replaces gauss_tpu/ops/dma_gather.py:gather_rows (_gather_kernel), the
// Pallas TPU kernel that keeps 128 per-row DMAs in flight.
//
// What bounds it on this card: pure data movement.  Every byte is read once
// and written once, so the floor is 2 * N * S bytes over HBM bandwidth.  At
// the main path's shapes (N ~ 1e5 rows of S ~ 34 kB) that is ~7 GB of traffic
// per prepared batch.
//
// What the design does about it: one block per output row (grid-stride over
// rows), every thread moving 16 bytes per load/store (int4), neighbouring
// threads on neighbouring addresses, so each warp issues 512-byte coalesced
// transactions.  Row offsets are 64-bit: row * S exceeds 2^31 at the main
// path's panel (64k rows x 34k columns).  The padding sentinel of
// prepare_resident_panel (window_kernel.py, "rows < 0 are padding") is
// folded in: a negative index writes zeros instead of reading.  An index
// >= R is the caller's error; it is treated like a sentinel so that it never
// reads outside the panel.
//
// Requires S % 16 == 0 and 16-byte aligned base pointers (the wrapper checks;
// population segments are padded to 64 columns, so the port's panels always
// qualify).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const int8_t* __restrict__ G,
                   const int32_t* __restrict__ idx,
                   int8_t* __restrict__ out,
                   int64_t n, int64_t S, int64_t R) {
  const int64_t s16 = S / 16;
  for (int64_t r = blockIdx.x; r < n; r += gridDim.x) {
    const int32_t src = idx[r];
    int4* o = reinterpret_cast<int4*>(out + r * S);
    if (src < 0 || src >= R) {
      const int4 z = make_int4(0, 0, 0, 0);
      for (int64_t c = threadIdx.x; c < s16; c += kThreads) o[c] = z;
    } else {
      const int4* g = reinterpret_cast<const int4*>(G + (int64_t)src * S);
      for (int64_t c = threadIdx.x; c < s16; c += kThreads) o[c] = g[c];
    }
  }
}

}  // namespace

extern "C" int gauss_gather_rows(const void* G, const void* idx, void* out,
                                 long long n, long long S, long long R,
                                 void* stream) {
  if (n <= 0) return 0;
  const long long max_grid = 1LL << 20;
  const unsigned grid = (unsigned)(n < max_grid ? n : max_grid);
  gather_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int8_t*)G, (const int32_t*)idx, (int8_t*)out, n, S, R);
  return (int)cudaGetLastError();
}

extern "C" const char* gauss_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

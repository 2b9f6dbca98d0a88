// panel_decoder.cpp -- multithreaded BGZF panel decoder.
//
// Native (C++) replacement for the reference's single-threaded
// bgzf.c/khash.h I/O layer (reference: src/bgzf.c, src/gauss.cpp
// ReadGenotype/MakeSnpVec seek loops).  Design differences:
//   * whole-file block index built once, blocks inflated in parallel
//     with a thread pool (zlib raw inflate per 64KB BGZF block);
//   * rows located by virtual offset (coffset<<16 | uoffset) and parsed
//     straight into a caller-provided int8 dosage matrix + float64 AF
//     matrix -- one pass, no per-SNP reopen/seek.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Built on first use by gauss_tpu_torch/io/native.py (g++ -O3 -shared -fPIC
// ... -lz -lpthread into gauss_tpu_torch/_build/).

#include <zlib.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct BlockEntry {
  int64_t coffset;   // compressed offset of block start
  int64_t uoffset;   // cumulative uncompressed offset
  int32_t clen;      // compressed block length
  int32_t ulen;      // uncompressed payload length
};

struct Bgzf {
  std::vector<uint8_t> raw;          // whole compressed file
  std::vector<BlockEntry> blocks;    // block index
  std::vector<uint8_t> data;         // fully inflated payload
  std::string error;
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t got = fread(out.data(), 1, out.size(), f);
  fclose(f);
  return got == out.size();
}

// Parse the BGZF block chain (headers only; cheap single pass).
bool index_blocks(Bgzf& bg) {
  const uint8_t* p = bg.raw.data();
  size_t n = bg.raw.size();
  size_t off = 0;
  int64_t uoff = 0;
  while (off + 18 <= n) {
    if (p[off] != 0x1f || p[off + 1] != 0x8b) {
      bg.error = "bad gzip magic at block " + std::to_string(off);
      return false;
    }
    uint16_t xlen;
    memcpy(&xlen, p + off + 10, 2);
    // find BC subfield
    size_t xs = off + 12, xe = xs + xlen;
    int32_t bsize = -1;
    while (xs + 4 <= xe) {
      uint8_t si1 = p[xs], si2 = p[xs + 1];
      uint16_t slen;
      memcpy(&slen, p + xs + 2, 2);
      if (si1 == 0x42 && si2 == 0x43 && slen == 2) {
        uint16_t bs;
        memcpy(&bs, p + xs + 4, 2);
        bsize = bs;
        break;
      }
      xs += 4 + slen;
    }
    if (bsize < 0) {
      bg.error = "missing BC subfield at " + std::to_string(off);
      return false;
    }
    int32_t clen = bsize + 1;
    if (off + clen > n) {
      bg.error = "truncated block at " + std::to_string(off);
      return false;
    }
    uint32_t isize;
    memcpy(&isize, p + off + clen - 4, 4);
    bg.blocks.push_back({static_cast<int64_t>(off), uoff, clen,
                         static_cast<int32_t>(isize)});
    uoff += isize;
    off += clen;
  }
  return true;
}

// Inflate all blocks in parallel into bg.data.
bool inflate_all(Bgzf& bg, int n_threads) {
  int64_t total = 0;
  for (auto& b : bg.blocks) total += b.ulen;
  bg.data.resize(static_cast<size_t>(total));
  std::atomic<size_t> next{0};
  std::atomic<bool> ok{true};
  auto worker = [&]() {
    while (true) {
      size_t i = next.fetch_add(1);
      if (i >= bg.blocks.size() || !ok.load()) return;
      const BlockEntry& b = bg.blocks[i];
      if (b.ulen == 0) continue;
      uint16_t xlen;
      memcpy(&xlen, bg.raw.data() + b.coffset + 10, 2);
      const uint8_t* cdata = bg.raw.data() + b.coffset + 12 + xlen;
      int32_t cdata_len = b.clen - 12 - xlen - 8;
      z_stream zs;
      memset(&zs, 0, sizeof(zs));
      if (inflateInit2(&zs, -15) != Z_OK) { ok = false; return; }
      zs.next_in = const_cast<uint8_t*>(cdata);
      zs.avail_in = cdata_len;
      zs.next_out = bg.data.data() + b.uoffset;
      zs.avail_out = b.ulen;
      int r = inflate(&zs, Z_FINISH);
      inflateEnd(&zs);
      if (r != Z_STREAM_END) { ok = false; return; }
    }
  };
  std::vector<std::thread> pool;
  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  for (int t = 0; t < nt; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return ok.load();
}

// virtual offset -> flat offset in bg.data
int64_t vaddr_to_flat(const Bgzf& bg, int64_t vaddr) {
  int64_t coffset = vaddr >> 16;
  int64_t uoffset = vaddr & 0xffff;
  // binary search block by coffset
  size_t lo = 0, hi = bg.blocks.size();
  while (lo + 1 < hi) {
    size_t mid = (lo + hi) / 2;
    if (bg.blocks[mid].coffset <= coffset) lo = mid; else hi = mid;
  }
  if (lo >= bg.blocks.size() || bg.blocks[lo].coffset != coffset) return -1;
  return bg.blocks[lo].uoffset + uoffset;
}

std::string g_error;
std::mutex g_error_mu;

void set_error(const std::string& e) {
  std::lock_guard<std::mutex> l(g_error_mu);
  g_error = e;
}

}  // namespace

extern "C" {

// Opaque handle API: load + fully inflate a BGZF file once.
void* gauss_bgzf_open(const char* path, int n_threads) {
  auto* bg = new Bgzf();
  if (!read_file(path, bg->raw)) {
    set_error(std::string("cannot read ") + path);
    delete bg;
    return nullptr;
  }
  if (!index_blocks(*bg) || !inflate_all(*bg, n_threads)) {
    set_error(bg->error.empty() ? "inflate failed" : bg->error);
    delete bg;
    return nullptr;
  }
  bg->raw.clear();
  bg->raw.shrink_to_fit();
  return bg;
}

void gauss_bgzf_close(void* h) { delete static_cast<Bgzf*>(h); }

int64_t gauss_bgzf_size(void* h) {
  return static_cast<int64_t>(static_cast<Bgzf*>(h)->data.size());
}

// Copy the full inflated payload (for index files).
int gauss_bgzf_read_all(void* h, uint8_t* out, int64_t cap) {
  Bgzf* bg = static_cast<Bgzf*>(h);
  if (cap < static_cast<int64_t>(bg->data.size())) return -1;
  memcpy(out, bg->data.data(), bg->data.size());
  return 0;
}

// Decode panel rows at the given virtual offsets into G (int8) and af
// (double) matrices.  Layout per row (reference wire format,
// src/gauss.cpp:571-585):
//   geno_str_pop1 .. geno_str_popP  af1_pop1 .. af1_popP '\n'
// pop_sizes: all P population sizes; sel: indices of selected pops
// (ascending).  G gets n_rows x sum(sizes[sel]) dosages; af gets
// n_rows x P study AFs.  Either output may be null.  Parallel over rows.
// Returns 0 on success.
int gauss_decode_rows(void* h,
                      const int64_t* fpos, int64_t n_rows,
                      const int64_t* pop_sizes, int64_t num_pops,
                      const int64_t* sel, int64_t n_sel,
                      int8_t* G, double* af, int n_threads) {
  Bgzf* bg = static_cast<Bgzf*>(h);
  int64_t sel_width = 0;
  for (int64_t k = 0; k < n_sel; k++) sel_width += pop_sizes[sel[k]];
  const uint8_t* data = bg->data.data();
  const int64_t dsize = static_cast<int64_t>(bg->data.size());

  std::atomic<int64_t> next{0};
  std::atomic<int> err{0};
  auto worker = [&]() {
    while (true) {
      int64_t r = next.fetch_add(1);
      if (r >= n_rows || err.load()) return;
      int64_t pos = vaddr_to_flat(*bg, fpos[r]);
      if (pos < 0) { err = 1; return; }
      // walk fields
      int64_t p = pos;
      int64_t si = 0;  // selected-pop cursor
      for (int64_t k = 0; k < num_pops; k++) {
        // skip whitespace
        while (p < dsize && (data[p] == ' ' || data[p] == '\t')) p++;
        int64_t m = pop_sizes[k];
        if (p + m > dsize) { err = 2; return; }
        bool selected = (G != nullptr) && si < n_sel && sel[si] == k;
        if (selected) {
          int8_t* out = G + r * sel_width;
          int64_t col = 0;
          for (int64_t kk = 0; kk < si; kk++) col += pop_sizes[sel[kk]];
          for (int64_t j = 0; j < m; j++)
            out[col + j] = static_cast<int8_t>(data[p + j] - '0');
          si++;
        } else if (G != nullptr && si < n_sel && sel[si] < k) {
          err = 3; return;  // sel not ascending
        }
        p += m;
      }
      for (int64_t k = 0; k < num_pops; k++) {
        while (p < dsize && (data[p] == ' ' || data[p] == '\t')) p++;
        int64_t q = p;
        while (q < dsize && data[q] != ' ' && data[q] != '\t'
               && data[q] != '\n' && data[q] != '\r') q++;
        if (af != nullptr) {
          char buf[64];
          int64_t len = q - p < 63 ? q - p : 63;
          memcpy(buf, data + p, len);
          buf[len] = 0;
          af[r * num_pops + k] = strtod(buf, nullptr);
        }
        p = q;
      }
    }
  };
  std::vector<std::thread> pool;
  int nt = n_threads > 0 ? n_threads
                         : static_cast<int>(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > n_rows) nt = static_cast<int>(n_rows);
  for (int t = 0; t < nt; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return err.load();
}

const char* gauss_last_error() { return g_error.c_str(); }

}  // extern "C"

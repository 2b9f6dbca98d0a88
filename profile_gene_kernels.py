#!/usr/bin/env python
"""The gene kernels alone on one CUDA card, at chip_smoke.py phase 8's
bucket shapes on synthetic dosages.

    python3 profile_gene_kernels.py [--wide]

Buckets: jepegmix (POPS_33KG's 29 populations, 33,153 columns; 8 x 96,
16 x 126 and 16 x 58 genes) and jepeg (CEU, 6,360 columns; 8 x 96 and
16 x 184), the rows random dosages 0..2.  For each bucket, on the device
alone (torch.profiler, as chip_smoke.py's device_ms):

- gene_partials with the host's grouping of segments into blocks
  (``partials_groups``) and, in turns, one segment a block (8 warps) and
  the groups at 8 and at 4 warps, each bit-checked against its plain
  version, beside its byte bound;
- gene_stats_tail (statistics mode) and gene_corr (correlation mode),
  against their plain versions;
- an empty launch (torch.cuda._sleep(0)) on the same stream;
- the tail's clock64 cycles per phase, median over blocks, from a copy of
  csrc/gene_stats.cu with counters put in by text edits (built by nvcc
  with the package's flags into its own library under
  gauss_tpu_torch/_build/): set-up (barriers, the first round's TMA
  boxes, the constants), the wait for them, the row values, the chains,
  the rows' std and the pairs' correlations, the contractions with W.

--wide adds gene_partials at n = 64, 128 and 256 (the register route's
32 x 32 tiles, rows read again from L2 by each tile).  Each line carries
nvidia-smi's card name and power limit.  Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from gauss_tpu_torch.core.stats import full_f32_matmul, segment_bounds  # noqa: E402
from gauss_tpu_torch.ops import _build, gene_stats             # noqa: E402
from gauss_tpu_torch.utils.benchdata import POPS_33KG          # noqa: E402
from smoke_common import device_ms                             # noqa: E402

HBM_BYTES_PER_S = 3.35e12
SIZES = [s for _, s, _ in POPS_33KG]
MIX = (segment_bounds(SIZES), SIZES, [1.0 / len(SIZES)] * len(SIZES))
CEU = (np.array([0, 6360]), [6360], None)
BUCKETS = {"jepegmix": (MIX, [(8, 96), (16, 126), (16, 58)]),
           "jepeg": (CEU, [(8, 96), (16, 184)])}
WIDE = {"jepegmix wide": (MIX, [(64, 6), (128, 6), (256, 2)])}
PHASES = ("set-up", "wait", "row values", "chains", "std and R",
          "contractions")

# the clock64 counters: (text in the source, the counter put before or
# after it)
CLOCK_DECL = ("constexpr int kMaxPops = 64;",
              "__device__ long long g_clk[4096][7];\n")
MARK = "if ({}threadIdx.x == 0 && blockIdx.x < 4096) g_clk[blockIdx.x][{}] = clock64();\n"
CLOCK_EDITS = [
    ("  int b0, gb, I = 0, J = 0, tile = 0;\n", "after", 0, ""),
    ("  __syncthreads();                       // the barriers and "
     "constants set\n", "after", 1, ""),
    ("    mbar_wait(&full, round & 1);\n", "after", 2, "k0 == 0 && "),
    ("    // the chains, population after population\n", "before", 3,
     "k0 == 0 && "),
    ("  // each row's (std, mean), then each pair's correlation\n",
     "before", 4, ""),
    ("  if (!kStats) return;\n", "before", 5, ""),
    ("  if (a.nt == 1) return;\n", "before", 6, ""),
]


def clocked_source():
    """csrc/gene_stats.cu with the tail's clock64 counters put in, and a
    reader of them."""
    src = open(os.path.join(_build.SRC_DIR, "gene_stats.cu")).read()
    text, decl = CLOCK_DECL
    if src.count(text) != 1:
        raise SystemExit(f"clock edit no longer matches: {text!r}")
    src = src.replace(text, text + "\n" + decl)
    for text, where, i, cond in CLOCK_EDITS:
        if src.count(text) != 1:
            raise SystemExit(f"clock edit no longer matches: {text!r}")
        mark = "  " + MARK.format(cond, i)
        src = src.replace(text, text + mark if where == "after"
                          else mark + text)
    return src + ('\nextern "C" int gene_clk_read(long long* host) {\n'
                  "  return (int)cudaMemcpyFromSymbol(host, g_clk, "
                  "sizeof(g_clk));\n}\n")


def clocked_library():
    """The kernel library built with clocked_source() in place of
    gene_stats.cu."""
    out = os.path.join(_build.BUILD_DIR, "profile_gene_kernels")
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "gene_stats.cu")
    with open(path, "w") as fh:
        fh.write(clocked_source())
    shutil.copy(os.path.join(_build.SRC_DIR, "hopper.cuh"), out)
    srcs = [s for s in _build._sources() if not s.endswith("gene_stats.cu")]
    so = os.path.join(out, "libgene_clock.so")
    _build.compile_library(srcs + [path], so)
    lib = ctypes.CDLL(so)
    for name, argtypes in _build._SIGNATURES.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    lib.gauss_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gauss_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bucket_inputs(bounds, npad, B, gen, dev):
    """Random dosages [B, npad, S] and the bucket's ids / Wz (the last
    row of each gene a pad row)."""
    S = -(-int(bounds[-1]) // 16) * 16
    Gb = torch.randint(0, 3, (B, npad, S), dtype=torch.int8, device=dev,
                       generator=gen)
    ids = torch.arange(B * npad, dtype=torch.int32, device=dev)
    ids[npad - 1::npad] = -1
    Wz = torch.randn((B * npad, 7), dtype=torch.float64, device=dev,
                     generator=gen)
    return Gb, ids, Wz


def partials_variants():
    """The host's grouping, and the alternatives it was chosen over."""
    auto = gene_stats.partials_groups
    return {"groups": auto,
            "segment a block, 8 warps":
                lambda b, n, S, B: (list(range(len(b))), 8),
            "groups, 8 warps": lambda b, n, S, B: (auto(b, n, S, B)[0], 8),
            "groups, 4 warps": lambda b, n, S, B: (auto(b, n, S, B)[0], 4)}


def time_partials(Gb, bounds):
    """{variant: device ms} of gene_partials, each bit-checked."""
    auto = gene_stats.partials_groups
    with full_f32_matmul():
        plain = gene_stats.gene_partials_plain(Gb, bounds)
    out = {}
    try:
        for name, fn in partials_variants().items():
            gene_stats.partials_groups = fn
            got = gene_stats.gene_partials(Gb, bounds)
            if not all(torch.equal(a, b) for a, b in zip(got, plain)):
                raise AssertionError(f"gene_partials ({name}) is not "
                                     f"bit-equal to its plain version")
            out[name] = device_ms(
                lambda: gene_stats.gene_partials(Gb, bounds)).ms
    finally:
        gene_stats.partials_groups = auto
    return out


def time_tail(part, sizes, wgts, ids, Wz):
    """Device ms of gene_stats_tail and gene_corr, checked against their
    plain versions (CorG bit-equal, the statistics normwise)."""
    got = gene_stats.gene_stats_tail(*part, sizes, wgts, ids, Wz, 0.1)
    ref = gene_stats.gene_stats_tail_plain(*part, sizes, wgts, ids, Wz, 0.1)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    corr = gene_stats.gene_corr(*part, sizes, wgts)
    cref = gene_stats.gene_corr_plain(*part, sizes, wgts)
    if not torch.equal(corr.nan_to_num(7.0).view(torch.int64),
                       cref.nan_to_num(7.0).view(torch.int64)):
        raise AssertionError("gene_corr is not bit-equal to its plain "
                             "version")
    return dict(
        tail_device_ms=device_ms(lambda: gene_stats.gene_stats_tail(
            *part, sizes, wgts, ids, Wz, 0.1)).ms,
        corr_device_ms=device_ms(
            lambda: gene_stats.gene_corr(*part, sizes, wgts)).ms,
        tail_max_abs_err=err)


def tail_cycles(lib, part, sizes, wgts, ids, Wz, B, npad):
    """Median clock64 cycles per phase over the blocks of one statistics-
    mode launch of the clocked library."""
    saved = _build._LIB
    _build._LIB = lib
    try:
        for _ in range(3):
            gene_stats.gene_stats_tail(*part, sizes, wgts, ids, Wz, 0.1)
        torch.cuda.synchronize()
    finally:
        _build._LIB = saved
    buf = np.zeros((4096, 7), dtype=np.int64)
    lib.gene_clk_read(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))
    genes = gene_stats.tail_layout(npad, part[0].shape[0])[2]
    b = buf[:-(-B // genes)]
    return {name: int(np.median(b[:, i + 1] - b[:, i]))
            for i, name in enumerate(PHASES)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--wide", action="store_true",
                    help="also gene_partials at n = 64, 128, 256")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gene_kernels.py needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    _build.library()
    clocked = clocked_library()
    gen = torch.Generator(device=dev).manual_seed(0)
    floor = device_ms(lambda: torch.cuda._sleep(0)).ms
    print(json.dumps(dict(card=card, empty_launch_device_ms=floor)),
          flush=True)
    cases = dict(BUCKETS, **(WIDE if args.wide else {}))
    for label, ((bounds, sizes, wgts), buckets) in cases.items():
        for npad, B in buckets:
            Gb, ids, Wz = bucket_inputs(bounds, npad, B, gen, dev)
            nbytes = B * npad * int(bounds[-1])
            row = dict(card=card, case=label, npad=npad, B=B,
                       bytes_read=nbytes,
                       partials_bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       partials_device_ms=time_partials(Gb, bounds))
            if npad <= 256:
                part = gene_stats.gene_partials(Gb, bounds)
                row.update(time_tail(part, sizes, wgts, ids, Wz))
                if label in BUCKETS:
                    row["tail_cycles"] = tail_cycles(
                        clocked, part, sizes, wgts, ids, Wz, B, npad)
            print(json.dumps(row), flush=True)
            del Gb
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

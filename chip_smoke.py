#!/usr/bin/env python
"""Drive gauss_tpu_torch's region paths once on one CUDA card and check
them.

    python3 chip_smoke.py [--snps N]

Phases (each prints its evidence; any failure exits non-zero):

1. device  -- needs torch.cuda; prints the card and its power limit.
2. build   -- compiles the CUDA kernels (K1 gram, K2 gather, K3/K4, the
              region tail's, the Cholesky solve's, the gene path's) from
              gauss_tpu_torch/csrc
              with nvcc for sm_90a; prints ptxas's registers, spills and
              shared memory per kernel and K1's dynamic shared memory.
3. main    -- the bench workload: a 33KG-shaped panel (29 populations,
              33,153 subjects) of --snps SNPs at 1,500 SNPs/Mb, 40%
              measured, 1 Mb windows with 500 kb wings, imputed by
              GenomeEngine.prepare_mix -> impute_region (twice, blocking)
              -> impute_regions (8 passes, 2 in flight).  The kernels'
              launch counts must rise during it: K1 twice and each region
              tail kernel (corr_mm, corr_um_rhs, cholesky_solve,
              impute_finalize) once per region call.
4. kernels -- each kernel against its plain PyTorch version on the card,
              on the main path's own region batch (K1 rel err <= 1e-6,
              K2 bit-equal), timed with CUDA events beside its bound (the
              larger of its operations over the int8 peak and its bytes
              over the HBM rate) and one PyTorch call doing the same
              work (torch._int_mm for K1, torch.index_select for K2).
              Then the region tail's kernels on the same batch: corr_mm
              on K1's Gram (B11 exactly symmetric; B11 and std_m within
              TAIL_TOL of the plain version), corr_um_rhs on the kernel's
              std_m / mi_m (the right-hand side within TAIL_TOL),
              cholesky_solve on those blocks (info equal, Y normwise
              within SOLVE_TOL of the library pair cholesky_ex +
              solve_triangular, its plain version, and no less accurate
              than SOLVE_ACC x that pair against a float64 solve; then
              the same slab with window 1 indefinite at a middle pivot
              and window 2 NaN at another: the call returns, info names
              those pivots, the other windows bit-equal to the slab
              without them), impute_finalize on the kernel's solve (z
              and info within FINAL_RTOL), each under full_f32_matmul,
              timed beside its bound (bytes at the HBM rate or f32
              operations at 67 TFLOP/s; for cholesky_solve its 3xTF32
              products, 3 FLOP at the TF32 peak of 495 TFLOP/s, with the
              f32 and byte figures beside) and its plain version, the
              torch passes it replaced (for cholesky_solve the library
              pair, also its library_ms); one profiled region call must
              run the solve's one kernel and no kernel of the library's
              potrf / trsm.
5. parity  -- the first window against the port's float64 window path
              (its correlation blocks on the card, its solve on the
              host): max|dZ| <= 1e-4 on imputed rows, measured rows
              bit-equal; that float64 window against a CPU engine's
              within PERCALL_RTOL = 1e-12 (normwise, as phase 14).
6. LD      -- PreparedRun.ld_region over the same region (1 Mb windows,
              computeLD semantics), fetch "i16tri" and "f32" on the same
              prepared run: K1 runs at least once per call and K2 gathers
              the measured panel; K1 and K2 against their plain versions
              on the LD batch's own inputs (band offsets at each window's
              first measured row); the first, middle and last windows
              against the float64 ldkernels.weighted_corr (max|dr| <=
              2e-4, plus LD_I16_MAX_ERR for i16tri; unit diagonal exact);
              every window's float64 matrix, made on the card, bit-equal
              to the host formula on the same correlations
              (unpack_tri_i16 of the int16 triangle; the f32 block cast),
              C-contiguous and not pinned; ld_region's host split
              (windows, batch, device + copy, assembly) per mode;
              K1 there with its bound and yardstick as in phase 4, and
              corr_mm (launched by every call) on the LD batch as in
              phase 4.
7. qcat    -- PreparedRun.qcat_region over the same region with impute's
              windows (its region batch rebuilt, so K2 runs too): K1 twice
              per slab of windows, checked against its plain version at
              both shapes with its bound and yardstick, corr_mm,
              corr_um_rhs and cholesky_solve (each launched once per slab;
              the solve with want_l, L held too) as in phase 4, and the
              profiled region call as there;
              the first, middle and last windows
              against the float64 host qcat (_qcat_core on
              _build_corr_blocks_fn's blocks): qcat_m equal, max|dr| <=
              1e-4 on r = t / sqrt(m - 3).
8. jepeg   -- GenomeEngine.prepare_genes -> PreparedGenes.jepeg_region
              on the same store: 280 genes x 24 annotated SNPs
              (utils/testing.make_annotation), jepegmix (the main path's
              weights) and jepeg (one population), jepeg_region twice
              each; K2 launches at least once per gene bucket and is
              checked against its plain version on the path's own ids
              (bit-equal, with its bound and yardstick); gene_partials
              and gene_stats_tail launch exactly once per bucket each
              (gene_corr, the tail's correlation mode, never) and are
              checked against their plain versions on each of the
              path's buckets (partials and CorG bit-equal, CovU / WWt / U
              within GENE_TAIL_RTOL / GENE_TAIL_ATOL normwise), timed
              (CUDA events, median of 5) beside their bound (int8
              operations at the int8 peak or float64 ones at 67 TFLOP/s,
              or bytes at the HBM rate) and their plain versions, summed
              over one call's buckets; the gene statistics on the card
              (CUDA events), jepeg_region's wall, genes/s, and
              torch.profiler's CUDA kernels over one jepeg_region (at most
              GENE_KERNELS_PER_BUCKET a bucket); every gene against the
              same call on a CPU engine (chisq and p-values rtol 1e-9;
              df, geneid, top_categ, top_snp equal).
9. probe7  -- the probe's own entry point (probes/probe7_int4.main: the
              TPU probe's int4 check, the largest resident blocks in
              clusters of 1, 8 and 16), whose K3 and K4 launch counts
              must rise; then K3 (int4 dot, the SASS tensor-core
              instructions it compiled to: integer wgmma, IGMMA, and no
              IMMA) at the TPU probe's shape (256 x 2048), at K1's
              yardstick shape (A 55,040 x 34,176, B 1,280 x 34,176) and
              at the GPU tests' edge shapes, and K4 (resident row sums)
              at every size that fits one cluster (int8 and int4,
              cluster 1 and 8; the capacities from the occupancy
              queries), each against its plain version, exactly, with
              its time, bound and yardstick (torch._int_mm; x.sum).  At
              K1's shape K3's product and its packing pass are timed
              apart.

10. runner -- models/runner.GenomeRunner on the same store and engine, in
              temporary run directories: analysis "impute" over the whole
              region in chunks of whole windows (at least 5 chunks at the
              full size): K1 and K2 must launch, every chunk ends "done",
              collect() has the rows of phase 3's whole-region call with z
              and info within SAME_TOL (the same windows through the same
              kernels, in batches of another size); a second
              run(resume=True) skips every chunk and launches no kernel;
              a run with one chunk made to fail
              records the failure against that chunk, finishes the others,
              and its resume retries that chunk alone, bit-equal to the
              first run.  One chunk's batch build, region call and kernels
              are timed apart.  Then analysis "qcat", "ld" (the first
              LD_CHUNKS chunks: its walls are the host's) and "jepeg"
              (phase 8's annotation; the gene kernels once per bucket
              each), each against the engine call of phase 7, 6 or 8.
              Per analysis: chunks, wall, rate,
              per-chunk elapsed, peak device memory.
11. stream -- the first STREAM_SNPS SNPs of the store at every subject,
              written as bgzf files (io/panel.write_panel), then the
              runner with panel_files= on an engine with no store, two
              chunks of two windows: bit-equal to the resident runner on
              the decoded files; every chunk but the first prefetched.
12. cli    -- gauss_tpu_torch.cli.main in-process with the default
              --device, on a panel-cache of phase 11's files:
              impute-genome (twice: the second resumes and launches
              nothing), --status, impute-region --device-linalg,
              qcat-region, each bit-equal to the Python call; then
              impute_window with device_linalg on the first, middle and
              last window of the bench region against the float64 host
              window (max|dZ| <= 1e-4) and against the same window's rows
              of phase 3's region call (SAME_TOL); one more window under
              utils/timing.device_trace, whose Chrome trace must name
              both kernels.  The windows run right
              after phase 10's impute run, on its prepared state, which is
              then released, so that each later run's peak memory is its
              own.

13. mesh   -- GenomeEngine(store, mesh=...) on the bench store: a (1 x 1)
              mesh on the card (impute_region bit-equal to phase 3's
              frame: one shard, the same batch of windows, the same T1),
              then (1 x 2) and (2 x 2) over a repeated card (impute_region
              within MESH_TOL = 4e-5 of phase 3's in z and info, its first
              window within TF32_DZ of the float64 host window as phase 5
              holds one device).  On the (2 x 2) engine:
              qcat_region against phase 7 (qcat_m equal, r = t /
              sqrt(m - 3) within SAME_TOL), ld_region "i16tri" against
              phase 6 (one int16 step), jepegmix genes against phase 8
              (rtol 1e-12: exact partials over the shards; gene_partials
              once per bucket and shard, gene_stats_tail once per bucket
              and window group), impute_window
              on the middle window against phase 12's and a 2-chunk
              GenomeRunner against phase 10's rows (MESH_TOL);
              impute-region --mesh 1x1 on phase 12's cache bit-equal to
              the Python 1x1 call; with two cards, a (1 x 2) mesh over
              cuda:0 and cuda:1.  Each path's launches must be the
              formula's: K1 2 x W x S per impute or qcat slab, W x S per
              LD slab, K2 2 x W x S per aligned batch (W window groups of
              S subject shards).  K1 (mm, um) and K2 against their plain
              versions on shard 0's own inputs (checked_by_path "mesh");
              each mesh's region ms beside phase 3's.
14. percall -- the float64 per-call family on phase 11's bgzf files (one
              1 Mb window with 500 kb wings; every subject), each call on
              the card and on the CPU: dist, distmix, compute_ld, qcat,
              qcatmix, prep_qcat, prep_recessive_impute, jepeg, jepegmix
              (PERCALL_GENES genes from make_annotation), prep_zmix,
              prep_zmix5, zmix, and the engine's impute_window with
              device_linalg off; each pair within PERCALL_RTOL = 1e-12
              per column, normwise (exact integer products, the same
              float64 combines; the CPU's float64 sqrt is not always
              correctly rounded, so the blocks differ by an ulp), walls
              side by side.  jepeg and jepegmix's gene correlations run
              gene_partials and gene_corr (once per bucket each, and
              gene_stats_tail's statistics mode never: checked); the other
              products are torch matmuls, as gauss_tpu's are XLA's.

Phases 10 to 12 also hold K1 and K2 against their plain versions on each
path's own launches, as phases 4, 6, 7 and 8 do for theirs: one chunk's
batch of the impute and qcat runs, the last LD chunk's launch and the
measured half it gathered, one chunk's gene buckets, the middle single
window's one-window batch, a streamed chunk's batch on its own decoded
panel, and the batches of the three commands (checked_by_path in the
kernels line).  Results of the same windows through the same kernels are
held to bit-equality where the batches have the same size (a resumed
chunk, streaming, the commands) and to SAME_TOL in z and info where the
size differs (chunks or one window against the whole region: PyTorch
picks its triangular solve and reductions by batch count,
profile_runner.py), LD to one int16 step.

torch.backends.cuda.matmul.allow_tf32 is set True before phase 3, as a
caller of the engine might: it must still be True at the end, and phase
5's max|dZ| must stay at full-f32 size.

Calls shorter than SHORT_MS (K2 on the gene buckets, K3 at the probe
shape, K4, and their yardsticks) and the gene kernels on each bucket
are timed twice: per call with CUDA
events, host included (cuda_ms), and on the device alone from
torch.profiler's kernel records (device_ms), which names the kernels.

Each path's kernel launch counts are set to 0 just before it runs and
read just after.  The line before the last is a JSON object
{"kernels": [...]}; the last is {"ok": true, "device": {...}}.
"""

import argparse
import collections
import contextlib
import ctypes
import dataclasses
import glob
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import pandas as pd
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import gauss_tpu_torch as pkg                                  # noqa: E402
from gauss_tpu_torch import cli                                # noqa: E402
from gauss_tpu_torch.config import PanelFiles                  # noqa: E402
from gauss_tpu_torch.core import genekernels, ldkernels        # noqa: E402
from gauss_tpu_torch.core.stats import full_f32_matmul         # noqa: E402
from gauss_tpu_torch.io import readers                         # noqa: E402
from gauss_tpu_torch.io.panel import write_panel               # noqa: E402
from gauss_tpu_torch.models import qcat                        # noqa: E402
from gauss_tpu_torch.models.genome import (GenomeEngine,       # noqa: E402
                                           PanelStore,
                                           _build_corr_blocks_fn,
                                           _fetch_flat)
from gauss_tpu_torch.models.runner import GenomeRunner         # noqa: E402
from gauss_tpu_torch.utils.timing import Tracer, device_trace  # noqa: E402
from gauss_tpu_torch.ops import (_build, gather, gene_stats,  # noqa: E402
                                 gram, region_tail)
from gauss_tpu_torch.probes import probe7_int4 as p7           # noqa: E402
from gauss_tpu_torch.utils.testing import make_annotation      # noqa: E402
from gauss_tpu_torch.ops.gram import ROW_TILE                  # noqa: E402
from gauss_tpu_torch.ops.window_kernel import (LD_I16_MAX_ERR,  # noqa: E402
                                               _gram_segments,
                                               _ResidentBlocks,
                                               build_resident_ld_corr,
                                               pack_tri_i16, unpack_tri_i16,
                                               win_slab)
from gauss_tpu_torch.parallel.mesh import (group_width,       # noqa: E402
                                           make_mesh)
from gauss_tpu_torch.utils.benchdata import (cached_panel,     # noqa: E402
                                             make_bench_input)
from smoke_common import (GENE_REPS, GENE_SNPS, MAIN_SNPS,    # noqa: E402
                          MEASURED_FRAC, STUDY_POP, IndexOf, cuda_ms,
                          device_ms, gene_annotation, host_wall)

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".bench_cache")   # generated panels (gitignored)
WINDOW_BP = 1_000_000
WING_BP = 500_000
N_PIPE = 8
K1_REL_TOL = 1e-6        # f32 folds of exact int32 segment sums
DZ_TOL = 1e-4            # f32 region solves vs the float64 host path
DR_LD_TOL = 2e-4         # f32 LD vs the float64 weighted correlations
DR_QCAT_TOL = 1e-4       # f32 qcat correlations vs the float64 host qcat
GENE_RTOL = 1e-9         # float64 gene statistics, card vs CPU
MESH_GENE_RTOL = 1e-12   # the same on a mesh: exact partials over shards
SAME_TOL = 1e-5          # the same windows through the same kernels in a
                         # batch of another size (runner chunks, one
                         # window alone): the triangular solve (looped
                         # trsm up to 8 matrices, batched above), the z2
                         # product and the info sum give other last bits
                         # per batch count, and the factorization for one
                         # matrix (profile_runner.py); measured 2.3e-6 ..
                         # 3.7e-6 in z.  Equal batch sizes: bit-equal
TF32_DZ = 2e-5           # phase 5's max|dZ| in full f32 is ~1e-5; with the
                         # tail's matmuls in TF32 it would be ~1e-3
MESH_TOL = 2 * TF32_DZ   # a mesh against one device: K1 folds each shard's
                         # exact per-population sums into f32 and the
                         # partials are added in f32, one device folds them
                         # all at once; each T1 moves z by up to TF32_DZ
                         # from an exact T1 (profile_mesh.py), so two of
                         # them differ by up to twice that
RUNNER_CHUNKS = 6        # the runner's chunks hold n_windows // 6 windows
LD_CHUNKS = 3            # the runner's ld run covers this many chunks: its
                         # walls are the host's (each window's matrix is
                         # compressed into the chunk's .npz)
STREAM_SNPS = 6_000      # streamed panel: 4 windows, 2 chunks of 2
STREAM_ZLIB_LEVEL = 1    # of the streamed panel's bgzf blocks: the Python
                         # writer's time is zlib's (level 6 took 26-28 s)
PERCALL_GENES = 40       # phase 14's genes over the streamed panel's 4 Mb
PERCALL_RTOL = 1e-12     # the per-call family, card against CPU, per
                         # column normwise (norm_rel): exact integer
                         # products, the same float64 combines; torch's
                         # CPU sqrt is an ulp off at times
SHORT_MS = 0.2           # calls shorter than this are also timed on the
                         # device alone (device_ms)
TAIL_TOL = 1e-5          # the region tail's blocks (B11, [B21^T | Z1]),
                         # kernel against plain version on the same T1: f32
                         # sums of the same products in another order
FINAL_RTOL = 1e-5        # z and info, kernel against plain version on the
                         # same solve output: f32 sums over the Mp rows in
                         # another order, relative to max(1, |value|)
SOLVE_TOL = 1e-5         # cholesky_solve against the library pair, Y and L
                         # normwise: two backward-stable f32 algorithms,
                         # blocked differently
SOLVE_ACC = 2.0          # its error against a float64 solve of the same
                         # inputs, at most this times the library pair's
GENE_TAIL_RTOL = 1e-12   # CovU, WWt, U: kernel against plain version on
GENE_TAIL_ATOL = 1e-13   # the card, normwise: float64 contractions with W
                         # summed in another order (CorG itself bit-equal)
GENE_KERNELS_PER_BUCKET = 12   # CUDA kernels a jepeg_region call may run
                         # per gene bucket (torch.profiler): K2 and its
                         # argsort, the two gene kernels, the results' cat
# published peaks of one H100 SXM (dense int8, TF32 and f64 tensor-core
# rates, f32 outside the tensor cores, HBM3 rate)
INT8_OPS_PER_S = 1979e12
TF32_FLOPS_PER_S = 495e12
FP32_FLOPS_PER_S = 67e12
# (f64 at the card's highest rate: the gene tail's elementwise combine
# could use only the CUDA cores' 34 TFLOP/s, so its bound stays a least time)
FP64_FLOPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
#: the region tail's kernels, their sources and the reference code they
#: replace (XLA at Precision.HIGHEST on the TPU; no Pallas kernel)
TAIL_KERNELS = {
    "corr_mm": ("gauss_tpu_torch/csrc/region_tail.cu",
                "no Pallas counterpart: gauss_tpu/ops/window_kernel.py:980 "
                "(_resident_block_builder, XLA at Precision.HIGHEST)"),
    "corr_um_rhs": ("gauss_tpu_torch/csrc/region_tail.cu",
                    "no Pallas counterpart: gauss_tpu/ops/window_kernel.py:"
                    "980 (_resident_block_builder, XLA at Precision.HIGHEST;"
                    " the [B21^T | Z1] concatenation at :1286)"),
    "cholesky_solve": ("gauss_tpu_torch/csrc/chol_solve.cu",
                       "no Pallas counterpart: gauss_tpu/ops/window_kernel.py"
                       ":1160-1258 (_blocked_cholesky_lower, "
                       "_blocked_trsm_lower; the region tail's solve at "
                       ":1278-1300, XLA at Precision.HIGHEST)"),
    "impute_finalize": ("gauss_tpu_torch/csrc/region_tail.cu",
                        "no Pallas counterpart: gauss_tpu/ops/window_kernel."
                        "py:1261 (build_resident_region_kernel's tail, z2 "
                        "and info, XLA at Precision.HIGHEST)"),
}
#: the gene path's kernels, their source and the reference code they
#: replace (one jitted XLA program on the TPU; no Pallas kernel)
GENE_KERNELS = {
    "gene_partials": ("gauss_tpu_torch/csrc/gene_stats.cu",
                      "no Pallas counterpart: gauss_tpu/core/genekernels.py:"
                      "194-208 (_gene_stats_body's per-population f32 Grams "
                      "and row sums, XLA; jitted in _gene_stats_unsharded "
                      ":223)"),
    "gene_stats_tail": ("gauss_tpu_torch/csrc/gene_stats.cu",
                        "no Pallas counterpart: gauss_tpu/core/genekernels."
                        "py:136-176, 210-219 (_corr_from_pop_partials, the "
                        "mask, ridge and W contractions of _gene_stats_body,"
                        " XLA)"),
}
#: kernel names of the library's Cholesky and triangular solve (cuSOLVER's
#: potrf, cuBLAS's trsm and what they call): none may run in a region call
LIBRARY_SOLVE = re.compile(r"potrf|trsm|trtri|getrf|syrk", re.I)


#: the region tail's kernel times on each path when each block computed one
#: tile, before the persistent design (chip_smoke.py on an NVIDIA H100 80GB
#: HBM3 at 700 W; the main path's shapes), printed beside this run's
ONE_TILE_MS = {("impute", "corr_mm"): 0.483, ("qcat", "corr_mm"): 0.481,
               ("LD", "corr_mm"): 0.152, ("impute", "corr_um_rhs"): 0.451,
               ("qcat", "corr_um_rhs"): 0.447,
               ("impute", "impute_finalize"): 0.077}


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def reset_counts():
    gram.launches = 0
    gather.launches = 0
    for counts in (p7.launches, region_tail.launches, gene_stats.launches):
        for k in counts:
            counts[k] = 0


def read_counts():
    return {"weighted_gram_t1": gram.launches,
            "gather_rows": gather.launches, **p7.launches,
            **region_tail.launches, **gene_stats.launches}


def tail_launched(counts, what, per_call):
    """Fail unless each region-tail kernel in ``per_call`` ({name: least
    launches}) ran at least that often."""
    short = {k: counts[k] for k, n in per_call.items() if counts[k] < n}
    if short:
        raise AssertionError(f"{what}: region tail kernels launched too "
                             f"rarely: {short}, want {per_call}")


def device_times(fn, lib_fn):
    """device_ms of a kernel's wrapper and of its yardstick, as row keys."""
    d, dk = device_ms(fn)[:2]
    ld, lk = device_ms(lib_fn)[:2]
    if d is None or ld is None:
        log("device-only times not measured: torch.profiler kept no "
            "kernel record")
        return {}
    return dict(device_ms=d, device_kernels=dk, library_device_ms=ld,
                library_kernels=lk)


def fmt_device(t):
    """The device-only part of a check's log line."""
    if "device_ms" not in t:
        return ""
    names = lambda ks: ", ".join(f"{k} {v:.4f}" for k, v in ks.items())
    return (f"; on the device alone (torch.profiler): wrapper "
            f"{t['device_ms']:.4f} ms ({names(t['device_kernels'])}), "
            f"yardstick {t['library_device_ms']:.4f} ms "
            f"({names(t['library_kernels'])})")


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda is not available: chip_smoke needs "
                           "one CUDA card")
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"device: {name}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32} (the engine changes neither)")
    print(smi, flush=True)
    return dev, name


def phase_build():
    t = time.perf_counter()
    _build.library()
    log(f"built {', '.join(os.path.basename(s) for s in _build._sources())}"
        f" with nvcc {' '.join(_build.NVCC_FLAGS)} in "
        f"{_build.build_seconds:.2f}s (load incl. {time.perf_counter()-t:.2f}s)")
    for line in _build.build_log.splitlines():
        if any(k in line for k in ("registers", "Compiling entry", "spill",
                                   "smem", "wgmma", "Performance")):
            log(f"  ptxas: {line.strip()}")
    log(f"K1 dynamic shared memory per CTA: "
        f"{_build.library().gauss_weighted_gram_smem()} bytes")
    stages = ctypes.c_int(0)
    for P, pooled in ((29, 0), (1, 1)):
        for name, sym in (("corr_mm", 1), ("corr_um_rhs", 0)):
            smem = _build.library().gauss_region_tail_smem(
                P, pooled, sym, ctypes.byref(stages))
            groups = _build.library().gauss_region_tail_groups(P, pooled,
                                                               sym)
            log(f"{name} tile pass at P={P}{' pooled' if pooled else ''}: "
                f"dynamic shared memory {smem} bytes per block, "
                f"{stages.value} ring stages, {groups} consumer groups")
    per_sm = ctypes.c_int(0)
    smem = _build.library().gauss_chol_solve_smem(ctypes.byref(per_sm))
    log(f"cholesky_solve: dynamic shared memory {smem} bytes per block "
        f"(a 3-stage ring of 32 k chunks: A's and B's boxes, B's lo), "
        f"{per_sm.value} blocks per SM")


def phase_main(dev, n_snps):
    bp_span = n_snps * 2000 // 3            # 1500 SNPs/Mb
    t = time.perf_counter()
    store = cached_panel(CACHE, n_snps, bp_span=bp_span)
    log(f"panel: {store.G.shape[0]} SNPs x {store.G.shape[1]} subjects, "
        f"{len(store.desc.pops)} populations, generated (or loaded from "
        f"{CACHE}) on the host in {time.perf_counter() - t:.1f}s")
    inp = make_bench_input(store, MEASURED_FRAC)
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}
    lo = int(store.index["bp"].min())
    hi = int(store.index["bp"].max())

    t = time.perf_counter()
    engine = GenomeEngine(store, device=dev, device_linalg=True)
    run = engine.prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    log(f"prepare_mix: {len(run.table)} SNPs in table "
        f"({time.perf_counter() - t:.1f}s); tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")
    if not torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("building an engine switched the caller's "
                             "TF32 off")

    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    res = run.impute_region(lo, hi, window_bp=WINDOW_BP, wing_size=WING_BP)
    first_s = time.perf_counter() - t
    n_imputed = int((res["type"] == 0).sum())
    t = time.perf_counter()
    res = run.impute_region(lo, hi, window_bp=WINDOW_BP, wing_size=WING_BP)
    block_s = time.perf_counter() - t
    t = time.perf_counter()
    for _, _, res in run.impute_regions([(lo, hi)] * N_PIPE,
                                        window_bp=WINDOW_BP,
                                        wing_size=WING_BP, depth=2):
        pass
    pipe_s = (time.perf_counter() - t) / N_PIPE
    launches = read_counts()
    n_regions = 2 + N_PIPE
    log(f"launches during the main path: {launches} over {n_regions} "
        f"region calls and 1 prepared batch")
    if launches["weighted_gram_t1"] < 2 * n_regions:
        raise AssertionError("K1 was not launched twice per region")
    if launches["gather_rows"] < 2:
        raise AssertionError("K2 was not launched for the prepared batch")
    tail_launched(launches, "the main path", dict.fromkeys(
        region_tail.launches, n_regions))

    batch = run._region_batch(lo, hi, WINDOW_BP, WING_BP)
    Wp, Mp, Up = batch.inputs[2].shape[0], batch.Mp, batch.Up
    S = batch.arrays[0].shape[1]
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"region: {len(batch.plans)} windows (Wp={Wp}, Mp={Mp}, Up={Up}, "
        f"S={S}), "
        f"{n_imputed} imputed SNPs per pass; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"first pass (incl. panel upload, K2 gathers, preparation) "
        f"{first_s:.3f}s; blocking pass {block_s:.4f}s -> "
        f"{n_imputed / block_s:.1f} SNPs/s; pipelined ({N_PIPE} passes, "
        f"2 in flight) {pipe_s:.4f}s/pass -> {n_imputed / pipe_s:.1f} SNPs/s")
    fn = run._kernel_fn("impute", Mp, Up)
    region_ms = cuda_ms(lambda: fn(*batch.arrays, *batch.inputs,
                                   *batch.compact), 5)
    log(f"region on the card (CUDA events, median of 5): {region_ms:.3f} ms")
    return engine, run, res, lo, hi, launches, batch, region_ms


def bound(ops, n_bytes):
    """(ms, "operations" or "bytes"): the least time the card could take,
    the larger of ops at the int8 peak and n_bytes at the HBM rate."""
    ops_ms = ops / INT8_OPS_PER_S * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                               "bytes")


def k1_bound(W, nx, ny, s_real, sym):
    """K1's bound on the work its inputs need: real subject columns, the
    lower triangle (diagonal included) in sym mode, each band read once,
    the output entries written once as f32."""
    entries = nx * (nx + 1) // 2 if sym else nx * ny
    return bound(2.0 * W * entries * s_real,
                 W * (nx if sym else nx + ny) * s_real + 4.0 * W * entries)


def k1_library_ms(A, B, a0, b0, nx, ny, reps):
    """torch._int_mm over the same int8 products in one call: every
    window's X band [W * nx, S] against the first window's Y band (the
    full square in sym mode: twice the triangle's work)."""
    Xb = gram._band(A, a0, nx).reshape(-1, A.shape[1])
    Yb = gram._band(B, b0[:1], ny)[0]
    ms = cuda_ms(lambda: torch._int_mm(Xb, Yb.t()), reps)
    del Xb, Yb
    torch.cuda.empty_cache()
    return ms


def k1_check(label, args, reps=5, plain_reps=2, s_real=None):
    """K1 against its plain version on one launch's arguments (a sym
    launch's lower triangles mirrored on both sides), then timed beside
    its plain version, its bound and its torch._int_mm yardstick.  Fails
    above K1_REL_TOL.  ``s_real``: the real subject columns of the bound
    (default: the segments' sizes; a subject shard holds fewer)."""
    got = gram.weighted_gram_t1(*args)
    ref = gram.weighted_gram_t1_plain(*args)
    if args[-1]:
        got, ref = gram.mirror_lower(got), gram.mirror_lower(ref)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    del got, ref
    ms = cuda_ms(lambda: gram.weighted_gram_t1(*args), reps)
    pms = cuda_ms(lambda: gram.weighted_gram_t1_plain(*args), plain_reps)
    A, B, sizes, _, _, a0, b0, nx, ny, sym = args
    offs = a0.cpu().numpy()
    Wp, S = offs.shape[0], A.shape[1]
    s_real = sum(sizes) if s_real is None else s_real
    b_ms, b_by = k1_bound(Wp, nx, ny, s_real, sym)
    lib = k1_library_ms(A, B, a0, b0, nx, ny, reps)
    log(f"K1 {label}: W={Wp} nx={nx} ny={ny} S={S} ({s_real} real) "
        f"segments={len(sizes)}{' sym' if sym else ''}, "
        f"{int((offs % ROW_TILE != 0).sum())} of {Wp} x offsets not a "
        f"multiple of {ROW_TILE}: max abs err {err:.3e}, rel {rel:.3e} "
        f"(tol {K1_REL_TOL:g}); kernel {ms:.3f} ms, bound {b_ms:.3f} ms "
        f"({b_by}) = {b_ms / ms:.1%} of bound, torch._int_mm {lib:.3f} ms "
        f"({'full square, 2x the triangle' if sym else 'same products'}),"
        f" plain {pms:.3f} ms")
    if not rel <= K1_REL_TOL:
        raise AssertionError(f"K1 {label} disagrees with its plain "
                             f"version: rel {rel:.3e}")
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib)


def sum_checks(checks):
    """One row for several launches: times summed, the largest error, the
    bound kind of the largest bound."""
    out = dict(max_abs_err=max(c["max_abs_err"] for c in checks))
    for k in ("ms", "plain_ms", "bound_ms", "library_ms"):
        out[k] = sum(c[k] for c in checks)
    out["bound_by"] = max(checks, key=lambda c: c["bound_ms"])["bound_by"]
    return out


def k2_check(label, G, rows, reps=5, device_too=True):
    """K2 against its plain version on one gather's row ids (-1 =
    sentinel), then timed beside its plain version, its bound (each
    distinct panel row read once, every output row written once) and
    torch.index_select on the clamped ids (the same bytes; sentinel rows
    not zeroed).  Fails unless bit-equal.  A call shorter than SHORT_MS
    is also timed on the device alone, unless ``device_too`` is off."""
    idx = torch.from_numpy(rows).to(G.device)
    got = gather.gather_rows(G, idx)
    ref = gather.gather_rows_plain(G, idx)
    equal = bool(torch.equal(got, ref))
    del got, ref
    ms = cuda_ms(lambda: gather.gather_rows(G, idx), reps)
    pms = cuda_ms(lambda: gather.gather_rows_plain(G, idx), reps)
    clamped = idx.clamp(min=0)
    lib = cuda_ms(lambda: torch.index_select(G, 0, clamped), reps)
    N, S = idx.shape[0], G.shape[1]
    n_real = int((idx >= 0).sum())
    n_distinct = int(torch.unique(idx[idx >= 0]).numel())
    b_ms, b_by = bound(0.0, (n_distinct + N) * S)
    dev = (device_times(lambda: gather.gather_rows(G, idx),
                        lambda: torch.index_select(G, 0, clamped))
           if device_too and min(ms, lib) < SHORT_MS else {})
    log(f"K2 {label}: R={G.shape[0]} S={S} N={N} ({N - n_real} "
        f"sentinels, {n_distinct} distinct rows): bit-equal={equal}; "
        f"kernel {ms:.3f} ms per call "
        f"({2.0 * N * S / ms / 1e6:.0f} GB/s read+write), bound "
        f"{b_ms:.3f} ms ({b_by}) = {b_ms / ms:.1%} of bound, "
        f"torch.index_select {lib:.3f} ms, plain {pms:.3f} ms"
        f"{fmt_device(dev)}")
    if not equal:
        raise AssertionError(f"K2 {label} differs from its plain version")
    del clamped
    torch.cuda.empty_cache()
    return dict(max_abs_err=0.0, ms=ms, plain_ms=pms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, **dev)


def f32_bound(flops, n_bytes):
    """(ms, "operations" or "bytes"): the larger of ``flops`` at the f32
    peak outside the tensor cores and n_bytes at the HBM rate."""
    ops_ms = flops / FP32_FLOPS_PER_S * 1e3
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                               "bytes")


def solve_bounds(B, Mp, K, want_l):
    """cholesky_solve's bounds on one slab: (tensor ms, f32 ms, bytes ms,
    GFLOP, MB).  FLOP B (Mp^3 / 3 + Mp^2 K); the kernel does each product
    as three TF32 products on the tensor cores (3xTF32), so its bound is
    3 FLOP at the TF32 peak, with the same FLOP at the f32 peak outside
    the tensor cores and the bytes (B11's lower triangle and rhs read, Y,
    and with want_l L, written) at the HBM rate beside it."""
    flops = B * (Mp ** 3 / 3 + Mp * Mp * K)
    n_bytes = 4 * (B * Mp * (Mp + 1) // 2 + 2 * B * Mp * K
                   + (B * Mp * Mp if want_l else 0))
    return (3 * flops / TF32_FLOPS_PER_S * 1e3,
            flops / FP32_FLOPS_PER_S * 1e3,
            n_bytes / HBM_BYTES_PER_S * 1e3, flops / 1e9, n_bytes / 1e6)


def tail_check(label, kernel, plain, args, err, tol, n_bytes, flops,
               earlier=None, reps=5):
    """One region-tail kernel against its plain version (the torch passes
    it replaced) on one launch's arguments, both under full_f32_matmul as
    the resident kernels call them; ``err(got, ref)`` is the compared
    error, held to ``tol``.  Then both are timed (CUDA events) beside the
    kernel's bound and ``earlier``, the kernel's recorded time before its
    redesign (ONE_TILE_MS).  No single PyTorch call computes these
    functions: library_ms is None."""
    with full_f32_matmul():
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        e = err(got, ref)
        del got, ref
        ms = cuda_ms(lambda: kernel(*args), reps)
        pms = cuda_ms(lambda: plain(*args), reps)
    b_ms, b_by = f32_bound(flops, n_bytes)
    log(f"{label}: max err {e:.3e} (tol {tol:g}); kernel {ms:.3f} ms, "
        f"bound {b_ms:.3f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.2f} GFLOP f32) = {b_ms / ms:.1%} of bound"
        + ("" if earlier is None else f" (one tile a block: {earlier:.3f} ms "
           f"= {b_ms / earlier:.1%})")
        + f"; the torch passes it replaced (plain) {pms:.3f} ms")
    if not e <= tol:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{e:.3e}")
    torch.cuda.empty_cache()
    return dict(max_abs_err=e, ms=ms, plain_ms=pms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def _max_diff(a, b):
    return float((a - b).abs().max())


def _mm_err(got, ref):
    """B11's largest difference, infinite unless the kernel's block is
    exactly symmetric."""
    B11 = got[0]
    if not torch.equal(B11, B11.transpose(1, 2)):
        return float("inf")
    return max(_max_diff(B11, ref[0]), _max_diff(got[1], ref[1]))


def _final_err(got, ref):
    """z and info's largest difference relative to max(1, |value|); NaN
    where the other is NaN (failed windows, padded columns' 0 / 0)."""
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    d = (got - ref).abs() / ref.abs().clamp(min=1.0)
    return float(d[~nan].max())


def tail_checks(label, spec, Mp, Up, arrays, inputs, kind):
    """The region tail's kernels against their plain versions on one
    path's own batch, its first slab: K1's Grams (the kernel), then
    corr_mm and, for impute and qcat, corr_um_rhs on the kernel's std_m /
    mi_m; for impute impute_finalize on the solve of the kernel's blocks.
    ``kind``: "impute", "qcat" (arrays, inputs of the region batch) or
    "ld" (arrays = the LD batch's Xm, Spm, Mum, m_t0, m_mask).  Bounds:
    each input read once, each output written once; operations 2 f32
    flops per multiply-add of the rank-P sums (and of z and info)."""
    blocks = _ResidentBlocks(spec, Mp, Up)
    if kind == "ld":
        Xm, Spm, Mum, m_t0, m_mask = arrays
    else:
        Xm, Xu, Spm, Spu, Mum, Muu, Vu = arrays
        m_t0, u_t0, Z1, m_mask, u_mask = inputs
    alpha, w = blocks.weights(Spm.device)
    P, nst = alpha.shape[0], 1 if w is None else 2
    B = win_slab(m_t0.shape[0])
    m0, mm = m_t0[:B], m_mask[:B]
    diag = 1.0 if kind == "ld" else 1.0 + spec.lam
    t1 = blocks._t1(Xm, Xm, m0, m0, Mp, Mp, sym=True)
    lower = B * Mp * (Mp + 1) // 2
    mm_args = (t1, Spm, Mum, m0, mm, alpha, w, diag)
    checks = {"corr_mm": tail_check(
        f"{label} corr_mm (B={B}, Mp={Mp}, P={P}; B11 exactly symmetric, "
        f"B11 and std_m against the plain version)",
        region_tail.corr_mm, region_tail.corr_mm_plain, mm_args, _mm_err,
        TAIL_TOL, 4 * (lower + B * Mp * Mp + nst * B * Mp * P + B * Mp
                       + nst * B * Mp), 2 * nst * P * lower,
        ONE_TILE_MS.get((label, "corr_mm")))}
    if kind == "ld":
        return checks
    with full_f32_matmul():
        B11, std_m, mi_m = region_tail.corr_mm(*mm_args)
    del t1
    u0, um = u_t0[:B], u_mask[:B]
    z1 = Z1[:B].to(torch.float32)
    um_args = (blocks._t1(Xu, Xm, u0, m0, Up, Mp), Spu, Muu, Vu, u0, Spm,
               Mum, m0, std_m, mi_m, um, mm, z1, alpha, w)
    checks["corr_um_rhs"] = tail_check(
        f"{label} corr_um_rhs (B={B}, Up={Up}, Mp={Mp}, P={P}; the "
        f"right-hand side [B21^T | Z1])", region_tail.corr_um_rhs,
        region_tail.corr_um_rhs_plain, um_args, _max_diff, TAIL_TOL,
        4 * (B * Up * Mp + nst * B * Up * P + B * Up + nst * B * Mp * P
             + (2 + nst) * B * Mp + B * Up + B * Mp * (Up + 1)),
        2 * nst * P * B * Up * Mp, ONE_TILE_MS.get((label, "corr_um_rhs")))
    with full_f32_matmul():
        rhs = region_tail.corr_um_rhs(*um_args)
    del um_args
    checks["cholesky_solve"] = solve_check(label, B11, rhs, kind == "qcat")
    if kind == "impute":
        with full_f32_matmul():
            Y, _, bad = region_tail.cholesky_solve(B11, rhs)
        del rhs
        checks["impute_finalize"] = tail_check(
            f"{label} impute_finalize (B={B}, Mp={Mp}, Up={Up}; the solve's "
            f"output, strides {tuple(Y.stride())})",
            region_tail.impute_finalize, region_tail.impute_finalize_plain,
            (Y, bad), _final_err, FINAL_RTOL,
            4 * (B * Mp * (Up + 1) + 2 * B * Up + B), 4 * B * Up * Mp,
            ONE_TILE_MS.get((label, "impute_finalize")))
    return checks


def cuda_ms_fresh(setup, fn, reps):
    """cuda_ms of fn() alone when each call needs setup() first (a kernel
    that overwrites its inputs): setup is queued before each call's first
    event, so its device time is not counted."""
    for _ in range(2):
        setup()
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in events:
        setup()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def normwise(got, ref):
    """max|got - ref| / max|ref|."""
    return float((got - ref).abs().max() / ref.abs().max())


def solve_check(label, B11, rhs, want_l, reps=5):
    """cholesky_solve (in place) against its plain version, the library
    pair cholesky_ex + solve_triangular, on one slab's own blocks (corr_mm's
    B11, corr_um_rhs's column-major right-hand side), under
    full_f32_matmul: info equal; Y (and with want_l L) normwise within
    SOLVE_TOL of the plain version's; each against a float64 solve of the
    same f32 inputs, the kernel within SOLVE_ACC times the library's
    error.  Timed (CUDA events around the kernel alone, fresh copies of
    its inputs queued before each call) beside the library pair, which is
    both plain_ms and library_ms, and its bounds (solve_bounds): the
    tensor bound, 3 B (Mp^3 / 3 + Mp^2 K) FLOP at the TF32 peak (bound_ms),
    with the same FLOP at the f32 peak and the bytes beside it.  Then
    solve_fail_check on the same slab."""
    B, Mp, K = rhs.shape
    with full_f32_matmul():
        Bk, Rk = B11.clone(), rhs.clone()
        Y, L, info = region_tail.cholesky_solve(Bk, Rk, want_l)
        pY, pL, pinfo = region_tail.cholesky_solve_plain(B11, rhs, want_l)
        L64, _ = torch.linalg.cholesky_ex(B11.double())
        Y64 = torch.linalg.solve_triangular(L64, rhs.double(), upper=False)
        torch.cuda.synchronize()
        same_info = torch.equal(info, pinfo)
        err = normwise(Y, pY)
        acc, lib_acc = normwise(Y, Y64), normwise(pY, Y64)
        if want_l:
            err = max(err, normwise(L, pL))
            acc = max(acc, normwise(L, L64))
            lib_acc = max(lib_acc, normwise(pL, L64))
        del Y, L, pY, pL, L64, Y64

        def fresh():
            Bk.copy_(B11)
            Rk.copy_(rhs)

        ms = cuda_ms_fresh(fresh, lambda: region_tail.cholesky_solve(
            Bk, Rk, want_l), reps)
        pms = cuda_ms(lambda: region_tail.cholesky_solve_plain(
            B11, rhs, want_l), reps)
    t_ms, f_ms, b_ms, gflop, mb = solve_bounds(B, Mp, K, want_l)
    log(f"{label} cholesky_solve (B={B}, Mp={Mp}, K={K}, want_l={want_l}; "
        f"info equal={same_info}, {int((info != 0).sum())} failed): "
        f"normwise err {err:.3e} against the library pair (tol "
        f"{SOLVE_TOL:g}); against float64 {acc:.3e}, the library's "
        f"{lib_acc:.3e} ({acc / lib_acc:.2f}x, limit {SOLVE_ACC:g}x); "
        f"kernel {ms:.3f} ms, bound {t_ms:.3f} ms (operations: 3 x "
        f"{gflop:.2f} GFLOP at the TF32 peak, 3xTF32) = {t_ms / ms:.1%} of "
        f"bound; f32 bound {f_ms:.3f} ms = {f_ms / ms:.1%}, bytes "
        f"{b_ms:.3f} ms ({mb:.1f} MB); the library pair (plain, "
        f"library_ms) {pms:.3f} ms; 1 launch per slab")
    del Bk, Rk
    torch.cuda.empty_cache()
    if not (same_info and err <= SOLVE_TOL and acc <= SOLVE_ACC * lib_acc):
        raise AssertionError(f"{label} cholesky_solve disagrees with its "
                             f"plain version")
    solve_fail_check(label, B11, rhs, want_l)
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=t_ms,
                bound_by="operations", f32_bound_ms=f_ms,
                bytes_bound_ms=b_ms, library_ms=pms, err_f64=acc,
                library_err_f64=lib_acc)


def solve_fail_check(label, B11, rhs, want_l):
    """cholesky_solve on one slab with window 1 made indefinite at a middle
    pivot and window 2's pivot at 3/4 made NaN: the call returns, info is
    those pivots' 1-based indices and 0 elsewhere, and every other
    window's Y (and L) is bit-equal to the same slab's without the bad
    windows."""
    B, Mp, _ = rhs.shape
    if B < 3:
        raise AssertionError(f"{label}: a slab of {B} windows is too narrow "
                             f"for the failed-window check")
    p, q = Mp // 2 + 5, 3 * Mp // 4 + 7
    bad = B11.clone()
    bad[1, p, p] = -1.0
    bad[2, q, q] = float("nan")
    with full_f32_matmul():
        Y, L, info = region_tail.cholesky_solve(B11.clone(), rhs.clone(),
                                                want_l)
        bY, bL, binfo = region_tail.cholesky_solve(bad, rhs.clone(), want_l)
        torch.cuda.synchronize()
    want = [0] * B
    want[1], want[2] = p + 1, q + 1
    ok = torch.ones(B, dtype=torch.bool, device=rhs.device)
    ok[1:3] = False
    same = torch.equal(bY[ok], Y[ok]) and (
        not want_l or torch.equal(bL[ok], L[ok]))
    log(f"{label} cholesky_solve with failed windows (window 1 indefinite "
        f"at pivot {p + 1}, window 2 NaN at pivot {q + 1}): returned, info "
        f"{binfo[:3].tolist()} (expected {want[:3]}), the other {B - 2} "
        f"windows bit-equal to the slab without them: {same}")
    if binfo.tolist() != want or info.tolist() != [0] * B or not same:
        raise AssertionError(f"{label}: cholesky_solve with failed windows "
                             f"gave other info or other results")
    del Y, L, bY, bL, bad
    torch.cuda.empty_cache()


#: the kernel cholesky_solve launches (one persistent launch a slab)
SOLVE_KERNELS = ("chol_solve_kernel",)


def no_library_solve(label, fn):
    """One profiled region call: each of cholesky_solve's kernels ran and
    no kernel of the library's Cholesky or triangular solve did."""
    kernels = device_ms(fn, reps=1).kernels
    if not kernels:
        log(f"{label}: profiled region call kept no kernel record; the "
            f"library check is not measured")
        return
    lib = sorted(k for k in kernels if LIBRARY_SOLVE.search(k))
    ours = sorted(k for k in kernels if k.startswith(SOLVE_KERNELS))
    log(f"{label}: one profiled region call ran {len(kernels)} kernels; "
        f"the solve's: {', '.join(ours)}; the library's solver kernels: "
        f"{lib or 'none'}")
    if lib or len(ours) != len(SOLVE_KERNELS):
        raise AssertionError(f"{label}: the region call did not solve "
                             f"through cholesky_solve alone")


def segments(run):
    """K1's (sizes, padded sizes, weights) for the run's spec."""
    return _gram_segments(run.engine._spec(run.pop_sizes, run.wgts))


def phase_kernels(engine, run, batch, region_ms):
    """K1 and K2 against their plain versions on the main path's own
    region batch: its shifted panels, band offsets and gathered row ids
    (the aligned layout, which the engine picks on this card)."""
    Xm, Xu = batch.arrays[0], batch.arrays[1]
    m0, u0 = batch.inputs[0], batch.inputs[1]
    Wp, Mp, Up = m0.shape[0], batch.Mp, batch.Up
    if Xm.shape[0] != Wp * Mp or Xu.shape[0] != Wp * Up:
        raise AssertionError("the main path did not take the aligned "
                             "layout; K2's row ids below would not be its")
    seg = segments(run)
    pooled = _gram_segments(dataclasses.replace(
        engine._spec(run.pop_sizes, run.wgts), wgts=None))   # beta = 1
    k1 = sum_checks([k1_check("mm", (Xm, Xm, *seg, m0, m0, Mp, Mp, True)),
                     k1_check("um", (Xu, Xm, *seg, u0, m0, Up, Mp, False))])
    k1_check("mm pooled", (Xm, Xm, *pooled, m0, m0, Mp, Mp, True))
    spec = engine._spec(run.pop_sizes, run.wgts)
    tail = tail_checks("impute", spec, Mp, Up, batch.arrays, batch.inputs,
                       "impute")
    tail_ms = sum(c["ms"] for c in tail.values())
    log(f"region {region_ms:.3f} ms = K1 {k1['ms']:.3f} ms (mm + um) + "
        f"tail {region_ms - k1['ms']:.3f} ms, of which the tail kernels "
        f"{tail_ms:.3f} ms (" + ", ".join(f"{k} {c['ms']:.3f}"
                                         for k, c in tail.items())
        + f", the solve kernel among them) and the rest "
        f"{region_ms - k1['ms'] - tail_ms:.3f} ms")
    fn = run._kernel_fn("impute", Mp, Up)
    no_library_solve("impute", lambda: fn(*batch.arrays, *batch.inputs,
                                          *batch.compact))

    # K2 on the batch's own index vectors: both bands' row ids, -1
    # sentinels padding each window's band
    k2 = k2_check("impute batch", run._device_panel(),
                  np.concatenate(run._aligned_rows(batch.plans)))
    return {"weighted_gram_t1": k1, "gather_rows": k2, **tail}


def batch_checks(label, run, b, reps=3):
    """K1 (mm and um) and K2 (the measured and the unmeasured gather)
    against their plain versions on one region batch of a later path: the
    launches that path made to build and run this batch, at its own
    window count, band heights and row ids."""
    Xm, Xu = b.arrays[0], b.arrays[1]
    m0, u0 = b.inputs[0], b.inputs[1]
    if Xm.shape[0] != m0.shape[0] * b.Mp or Xu.shape[0] != u0.shape[0] * b.Up:
        raise AssertionError(f"{label}: not the aligned layout; K2's row "
                             f"ids below would not be the path's")
    seg = segments(run)
    k1 = sum_checks([
        k1_check(f"{label} mm", (Xm, Xm, *seg, m0, m0, b.Mp, b.Mp, True),
                 reps),
        k1_check(f"{label} um", (Xu, Xm, *seg, u0, m0, b.Up, b.Mp, False),
                 reps)])
    rows_m, rows_u = run._aligned_rows(b.plans)
    k2 = sum_checks([
        k2_check(f"{label} measured rows", run._device_panel(), rows_m, reps,
                 device_too=False),
        k2_check(f"{label} unmeasured rows", run._device_panel(), rows_u,
                 reps, device_too=False)])
    return {"weighted_gram_t1": k1, "gather_rows": k2}


def phase_parity(run, res, lo):
    t = time.perf_counter()
    a = run._impute_window_host(lo, lo + WINDOW_BP - 1, WING_BP).table
    bmask = (res["bp"] >= lo) & (res["bp"] <= lo + WINDOW_BP - 1)
    b = res[bmask].reset_index(drop=True)
    if len(a) != len(b) or not (a["rsid"].to_numpy()
                                == b["rsid"].to_numpy()).all():
        raise AssertionError("first window rows differ from the host path")
    imp = a["type"].to_numpy() == 0
    za, zb = a["z"].to_numpy(), b["z"].to_numpy()
    if not np.isfinite(zb[imp]).all():
        raise AssertionError("non-finite imputed z")
    max_dz = float(np.abs(za[imp] - zb[imp]).max())
    max_dinfo = float(np.abs(a["info"].to_numpy()[imp]
                             - b["info"].to_numpy()[imp]).max())
    measured_equal = bool(np.array_equal(za[~imp], zb[~imp]) and
                          np.array_equal(a["info"].to_numpy()[~imp],
                                         b["info"].to_numpy()[~imp]))
    log(f"parity, first window vs float64 host path ({imp.sum()} imputed, "
        f"{(~imp).sum()} measured rows, host {time.perf_counter() - t:.1f}s)"
        f": max|dZ| = {max_dz:.3e} (tol {DZ_TOL:g}), max|dInfo| = "
        f"{max_dinfo:.3e}, measured rows bit-equal={measured_equal}")
    if not max_dz <= DZ_TOL or not measured_equal:
        raise AssertionError("first window disagrees with the host path")
    if not max_dz <= TF32_DZ:
        raise AssertionError(f"max|dZ| {max_dz:.3e} is not full-f32 size: "
                             f"TF32 reached the region tail")
    # the anchor's blocks ran on the card: the same window on a CPU engine
    store = run.engine.store
    t = time.perf_counter()
    cpu = GenomeEngine(store, device="cpu").prepare_mix(
        make_bench_input(store, MEASURED_FRAC),
        {p: 1.0 / store.desc.num_pops for p in store.desc.pops},
        af1_cutoff=0.01)._impute_window_host(lo, lo + WINDOW_BP - 1,
                                             WING_BP).table
    rel = norm_rel(a, cpu)
    log(f"parity, the float64 anchor (blocks on the card) against a CPU "
        f"engine's window ({time.perf_counter() - t:.1f}s with its join): "
        f"normwise rel diff {rel:.3e} (tol {PERCALL_RTOL:g})")
    if not rel <= PERCALL_RTOL:
        raise AssertionError("the float64 window on the card disagrees "
                             "with the CPU engine's")
    return max_dz, a


def k1_ms(run, Xa, Xb, a0, b0, na, nb, sym, reps=5):
    """K1 alone at a path's own shapes, CUDA events."""
    seg = segments(run)
    return cuda_ms(lambda: gram.weighted_gram_t1(Xa, Xb, *seg, a0, b0, na,
                                                 nb, sym), reps)


def same_bits(a, b):
    """float64 arrays of one shape with NaN where NaN and the same bits
    everywhere else."""
    nan = np.isnan(b)
    return (a.dtype == b.dtype == np.float64 and a.shape == b.shape
            and np.array_equal(np.isnan(a), nan)
            and np.array_equal(a.view(np.uint64)[~nan],
                               b.view(np.uint64)[~nan]))


def ld_split(run, lo, hi, fetch, reps):
    """ld_region's host split, ms (median of ``reps``): tiling the
    windows, building the batch, the device work and the copy of the
    float64 matrices to the host, assembling the dicts."""
    parts = collections.defaultdict(list)
    for _ in range(reps):
        t0 = time.perf_counter()
        windows = run._ld_windows(lo, hi, WINDOW_BP)
        t1 = time.perf_counter()
        fn, args, _ = run._ld_batches(windows, fetch)
        t2 = time.perf_counter()
        flat = _fetch_flat([fn(*a) for a in args])
        t3 = time.perf_counter()
        run._ld_assemble(windows, flat, fetch)
        t4 = time.perf_counter()
        for k, a, b in (("windows", t0, t1), ("batch", t1, t2),
                        ("device + copy", t2, t3), ("assembly", t3, t4)):
            parts[k].append(1e3 * (b - a))
        del flat
    return {k: statistics.median(v) for k, v in parts.items()}


def phase_ld(run, lo, hi, reps=5):
    """ld_region over the main path's region on the same prepared run:
    the default "i16tri" fetch, then "f32"."""
    windows = run._ld_windows(lo, hi, WINDOW_BP)
    W = len(windows)
    reset_counts()
    t = time.perf_counter()
    tri = run.ld_region(lo, hi, window_bp=WINDOW_BP)
    first_s = time.perf_counter() - t
    k1_first = gram.launches
    f32 = run.ld_region(lo, hi, window_bp=WINDOW_BP, fetch="f32")
    launches = read_counts()
    log(f"LD: {W} windows; launches during ld_region x2: {launches}; "
        f"first call (incl. K2 gather and preparation of the measured "
        f"panel) {first_s:.3f}s")
    if k1_first < 1 or launches["weighted_gram_t1"] - k1_first < 1:
        raise AssertionError("K1 was not launched by every ld_region call")
    if launches["gather_rows"] < 1:
        raise AssertionError("K2 was not launched for the LD panel")
    tail_launched(launches, "ld_region x2", {"corr_mm": 2})
    if [d["fetch"] for d in tri] != ["i16tri"] * W \
            or [d["fetch"] for d in f32] != ["f32"] * W:
        raise AssertionError("ld_region returned the wrong windows or modes")

    out = {}
    for fetch in ("i16tri", "f32"):
        fn, args, Mp = run._ld_batch(windows, fetch)
        dev_ms = cuda_ms(lambda: fn(*args), reps)
        res = fn(*args)
        n_bytes = res.numel() * res.element_size()
        del res
        wall = host_wall(lambda: run.ld_region(lo, hi, window_bp=WINDOW_BP,
                                               fetch=fetch))
        kms = k1_ms(run, args[0], args[0], args[3], args[3], Mp, Mp, True,
                    reps)
        split = ld_split(run, lo, hi, fetch, reps)
        log(f"LD {fetch}: W={W} (Wp={args[3].shape[0]}), Mp={Mp}: region "
            f"on the card {dev_ms:.3f} ms (CUDA events, median of {reps}; "
            f"the float64 matrices) = K1 {kms:.3f} ms + tail and expansion "
            f"{dev_ms - kms:.3f} ms; ld_region {wall * 1e3:.1f} ms wall "
            f"(median of 3) -> {W / wall:.1f} windows/s; {n_bytes} bytes "
            f"copied to the host; host split (ms, median of {reps}): "
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
        out[fetch] = dict(ms=dev_ms, k1_ms=kms, wall_s=wall, bytes=n_bytes,
                          split_ms=split)

    # every window's matrix, expanded on the card, against the host
    # formulas it replaced (the int16 triangle unpacked, the f32 block
    # cast) on the same correlations, bit for bit; pageable, C order
    corr = build_resident_ld_corr(run.engine._spec(run.pop_sizes, run.wgts),
                                  Mp)(*args[:5])
    raw = {"i16tri": pack_tri_i16(corr).cpu().numpy(),
           "f32": corr.cpu().numpy()}
    del corr
    for fetch, res in (("i16tri", tri), ("f32", f32)):
        for i, (m_rows, d) in enumerate(zip(windows, res)):
            M, c = len(m_rows), d["cormat"]
            ref = (unpack_tri_i16(raw[fetch][i], Mp, M) if fetch == "i16tri"
                   else raw[fetch][i, :M, :M].astype(np.float64))
            if not (same_bits(c, ref) and c.flags.c_contiguous
                    and not torch.from_numpy(c).is_pinned()):
                raise AssertionError(f"LD {fetch} window {i}: the card's "
                                     f"matrix is not the host formula's")
    log(f"LD expansion on the card: all {W} windows of i16tri and f32 "
        f"bit-equal to unpack_tri_i16 of the same int16 triangle and to "
        f"the f32 block cast; every cormat C-contiguous, none pinned")

    # K1 and K2 against their plain versions on the LD batch's own inputs:
    # the measured half, its band offsets (each window's first measured
    # row, mostly not ROW_TILE multiples) and the half's gathered row ids
    Xm, _, _, m_t0, _, _ = args
    checks = {"weighted_gram_t1": k1_check(
        "LD mm", (Xm, Xm, *segments(run), m_t0, m_t0, Mp, Mp, True))}
    cap = run._res[("half", 1)][0]
    checks["gather_rows"] = k2_check("LD measured half", run._device_panel(),
                                     run._half_rows(1, cap))
    checks.update(tail_checks("LD", run.engine._spec(run.pop_sizes, run.wgts),
                              Mp, 0, args[:5], None, "ld"))

    # the float64 parity on the first, middle and last windows, plus the
    # first window whose band offset is not a ROW_TILE multiple if none
    # of those has one
    t0 = m_t0.cpu().numpy()
    picks = sorted({0, W // 2, W - 1})
    if all(t0[i] % ROW_TILE == 0 for i in picks):
        picks += [i for i in range(W) if t0[i] % ROW_TILE][:1]
    out["i16tri"]["max_dr"] = out["f32"]["max_dr"] = 0.0
    for i in picks:
        m_rows = windows[i]
        G = run.engine.store.G[np.ix_(run.g_row[m_rows], run.subj_cols)]
        ref = ldkernels.set_diag(ldkernels.weighted_corr(
            G, G, run.pop_sizes, run.wgts), 1.0)
        fin = np.isfinite(ref)
        for fetch, res, tol in (("f32", f32, DR_LD_TOL),
                                ("i16tri", tri, DR_LD_TOL + LD_I16_MAX_ERR)):
            c = res[i]["cormat"]
            same_fin = bool(np.array_equal(np.isfinite(c), fin))
            dr = float(np.abs(c[fin] - ref[fin]).max())
            unit = bool((np.diag(c) == 1.0).all())
            log(f"LD parity, window {i} ({len(m_rows)} SNPs, band offset "
                f"{int(t0[i])}) vs float64 weighted_corr, {fetch}: max|dr| "
                f"= {dr:.3e} (tol {tol:.3e}), unit diagonal={unit}, finite "
                f"where the host is={same_fin}")
            if not (dr <= tol and unit and same_fin):
                raise AssertionError(f"LD {fetch} window {i} disagrees with "
                                     f"the host path")
            out[fetch]["max_dr"] = max(out[fetch]["max_dr"], dr)
    return launches, out, checks, tri


def phase_qcat(engine, run, lo, hi, reps=5):
    """qcat_region over the main path's windows on the same prepared run.
    Its cached region batches are dropped first, so qcat_region builds
    its own (aligned) batch and K2 runs on this path too."""
    run._res.clear()
    torch.cuda.empty_cache()
    reset_counts()
    t = time.perf_counter()
    q = run.qcat_region(lo, hi, window_bp=WINDOW_BP, wing_size=WING_BP)
    first_s = time.perf_counter() - t
    t = time.perf_counter()
    q = run.qcat_region(lo, hi, window_bp=WINDOW_BP, wing_size=WING_BP)
    block_s = time.perf_counter() - t
    launches = read_counts()
    b = run._region_batch(lo, hi, WINDOW_BP, WING_BP)
    Wp = b.inputs[0].shape[0]
    slabs = Wp // win_slab(Wp)
    log(f"qcat: {len(b.plans)} windows (Wp={Wp}, {slabs} slab(s), "
        f"Mp={b.Mp}, Up={b.Up}); launches during qcat_region x2: "
        f"{launches}")
    if launches["weighted_gram_t1"] < 2 * 2 * slabs:
        raise AssertionError("K1 was not launched twice per slab")
    if launches["gather_rows"] < 1:
        raise AssertionError("K2 was not launched for the qcat batch")
    tail_launched(launches, "qcat_region x2",
                  {"corr_mm": 2 * slabs, "corr_um_rhs": 2 * slabs,
                   "cholesky_solve": 2 * slabs})

    fn = run._kernel_fn("qcat", b.Mp, b.Up)
    dev_ms = cuda_ms(lambda: fn(*b.arrays, *b.inputs), reps)
    no_library_solve("qcat", lambda: fn(*b.arrays, *b.inputs))
    Xm, Xu = b.arrays[0], b.arrays[1]
    m0, u0 = b.inputs[0], b.inputs[1]
    seg = segments(run)
    k1 = sum_checks([
        k1_check("qcat mm", (Xm, Xm, *seg, m0, m0, b.Mp, b.Mp, True), reps),
        k1_check("qcat um", (Xu, Xm, *seg, u0, m0, b.Up, b.Mp, False),
                 reps)])
    kms = k1["ms"]
    checks = {"weighted_gram_t1": k1, **tail_checks(
        "qcat", engine._spec(run.pop_sizes, run.wgts), b.Mp, b.Up, b.arrays,
        b.inputs, "qcat")}
    wall = host_wall(lambda: run.qcat_region(lo, hi, window_bp=WINDOW_BP,
                                             wing_size=WING_BP))
    log(f"qcat region on the card {dev_ms:.3f} ms (CUDA events, median of "
        f"{reps}) = K1 {kms:.3f} ms (mm + um) + tail {dev_ms - kms:.3f} ms; "
        f"first call (incl. batch build) {first_s:.3f}s, second "
        f"{block_s:.4f}s; qcat_region {wall * 1e3:.1f} ms wall (median of "
        f"3) -> {len(q) / wall:.1f} tested SNPs/s ({len(q)} per pass)")

    # the float64 host qcat on the first, middle and last windows: bands
    # far from offset 0 and the last rows of the assembly's scatter
    bp = run.table["bp"].to_numpy()
    emit = np.zeros(len(bp), dtype=bool)
    for a, c, _ in b.plans:
        emit |= (bp >= a) & (bp <= c)
    sel = np.flatnonzero(emit)
    qm, qt, qc = (q[k].to_numpy() for k in ("qcat_m", "qcat_t",
                                            "qcat_chisq"))
    m0, u0 = b.inputs[0].cpu().numpy(), b.inputs[1].cpu().numpy()
    G = run.engine.store.G
    max_dr = 0.0
    for i in sorted({0, len(b.plans) // 2, len(b.plans) - 1}):
        lo0, hi0, (m_rows, u_rows, M, U, z1) = b.plans[i]
        Gm = torch.from_numpy(G[np.ix_(run.g_row[m_rows], run.subj_cols)])
        Gu = torch.from_numpy(G[np.ix_(run.g_row[u_rows], run.subj_cols)])
        B11, B21 = _build_corr_blocks_fn(run.pop_sizes, run.wgts)(Gm, Gu)
        B11.fill_diagonal_(1.0 + engine.settings.lambda_)
        pred = np.flatnonzero((bp[m_rows] >= lo0) & (bp[m_rows] <= hi0))
        num_eig, ref = qcat._qcat_core(B11.numpy(), B21.numpy(), z1, pred,
                                       engine.settings)
        dr = dt = dchi = 0.0
        m_equal = True
        for rows, t_ref, c_ref in ((m_rows[pred], ref["t_meas"],
                                    ref["chisq_meas"]),
                                   (u_rows, ref["t_unmeas"],
                                    ref["chisq_unmeas"])):
            pos = np.searchsorted(sel, rows)
            m_equal &= bool((qm[pos] == num_eig).all())
            r_dev = qt[pos] / np.sqrt(num_eig - 3.0)
            r_ref = t_ref / np.sqrt(num_eig - 3.0)
            dr = max(dr, float(np.abs(r_dev - r_ref).max()))
            dt = max(dt, float(np.abs(qt[pos] - t_ref).max()))
            dchi = max(dchi, float(np.abs(qc[pos] - c_ref).max()))
        log(f"qcat parity, window {i} ({M} measured, {len(pred)} tested "
            f"measured, {U} unmeasured; band offsets {int(m0[i])}, "
            f"{int(u0[i])}) vs float64 host qcat: qcat_m equal={m_equal} "
            f"(num_eig {num_eig}), max|dr| = {dr:.3e} (tol "
            f"{DR_QCAT_TOL:g}), max|dt| = {dt:.3e}, max|dchisq| = "
            f"{dchi:.3e}")
        if not (m_equal and dr <= DR_QCAT_TOL):
            raise AssertionError(f"qcat window {i} disagrees with the host "
                                 f"path")
        max_dr = max(max_dr, dr)
    return launches, dict(ms=dev_ms, k1_ms=kms, wall_s=wall,
                          max_dr=max_dr), checks, q

def gene_frames_agree(got, ref, rtol=GENE_RTOL):
    """(max relative difference of chisq and the p-values, whether df,
    geneid, top_categ and top_snp are equal) of two jepeg frames; inf
    when a value is outside ``rtol``."""
    got = got.sort_values("geneid", kind="stable").reset_index(drop=True)
    ref = ref.sort_values("geneid", kind="stable").reset_index(drop=True)
    same = len(got) == len(ref) and all(
        list(got[c]) == list(ref[c])
        for c in ("df", "geneid", "top_categ", "top_snp"))
    rel = 0.0
    for c in ("chisq", "jepeg_pval", "top_categ_pval", "top_snp_pval"):
        a, b = got[c].to_numpy(), ref[c].to_numpy()
        if not np.allclose(a, b, rtol=rtol, atol=1e-300,
                           equal_nan=True):
            rel = float("inf")
        d = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
        rel = max(rel, float(np.nanmax(d)) if len(d) else 0.0)
    return rel, same


def gene_bucket_inputs(buckets, idx, Ws, zs):
    """Panel row ids [N] and Wz [N, 7] (W^T, z; zero on pad rows) of
    every bucket in gene_stats_resident's row layout (one device)."""
    ids = genekernels._bucket_rows(buckets, idx)
    Wz = np.zeros((len(ids), 7))
    o = 0
    for npad, batch in buckets:
        for gi in batch:
            n = len(idx[gi])
            Wz[o:o + n, :6] = np.asarray(Ws[gi]).T
            Wz[o:o + n, 6] = zs[gi]
            o += npad
    return ids, Wz


def tail_flops(P, B, n, pooled):
    """float64 operations gene_stats_tail needs: per pair and population
    the combine's multiply-adds (pooled: one add), per pair the final
    steps, the ridge and six W multiply-adds, per row and population the
    std chain, per gene W W^T and W z."""
    per_pair = P * (1 if pooled else 7) + 5 + 2 + 12
    per_row = P * (2 if pooled else 8) + 3
    return B * (n * n * per_pair + n * per_row + 2 * 42 * n)


def _normwise_err(got, ref):
    """(max |got - ref| on ref's finite entries, over max |ref| there);
    inf unless the non-finite entries sit in the same places."""
    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(got), fin):
        return float("inf"), 1.0
    if not fin.any():
        return 0.0, 0.0
    return (float((got - ref)[fin].abs().max()),
            float(ref[fin].abs().max()))


def gene_checks(label, panel, buckets, idx, Ws, zs, sizes, wgts, lam,
                reps=5):
    """gene_partials and gene_stats_tail against their plain versions on
    each of a jepeg path's own gene buckets (gathered by K2 as the path
    gathers them): partials and CorG (gene_corr) bit-equal, CovU / WWt /
    U within GENE_TAIL_RTOL / GENE_TAIL_ATOL normwise; each timed (CUDA
    events, median of ``reps``) beside its plain version and its bound,
    summed over the buckets (one jepeg_region's work).  No single PyTorch
    call computes either: library_ms is None."""
    dev = panel.device
    ids, Wz = gene_bucket_inputs(buckets, idx, Ws, zs)
    ids_d = torch.from_numpy(ids).to(dev)
    Wz_d = torch.from_numpy(Wz).to(dev)
    bounds = genekernels._stat_bounds(sizes, wgts)
    P, cols = len(bounds) - 1, int(bounds[-1])
    rows = {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                    device_ms=0.0, ops=0.0, n_bytes=0.0, library_ms=None,
                    buckets=[])
            for k in GENE_KERNELS}
    o = 0
    for npad, batch in buckets:
        B = len(batch)
        bi = ids_d.narrow(0, o, B * npad)
        bw = Wz_d.narrow(0, o, B * npad)
        o += B * npad
        Gb = genekernels._gather_genes(panel, bi, B, npad)
        part = gene_stats.gene_partials(Gb, bounds)
        with full_f32_matmul():
            plain = gene_stats.gene_partials_plain(Gb, bounds)
        p_err = max(float((a - b).abs().max()) for a, b in zip(part, plain))
        p_equal = all(torch.equal(a, b) for a, b in zip(part, plain))
        corr_equal = same_bits(
            gene_stats.gene_corr(*part, sizes, wgts).cpu().numpy(),
            gene_stats.gene_corr_plain(*part, sizes, wgts).cpu().numpy())
        got = gene_stats.gene_stats_tail(*part, sizes, wgts, bi, bw, lam)
        ref = gene_stats.gene_stats_tail_plain(*part, sizes, wgts, bi, bw,
                                               lam)
        errs = [_normwise_err(a, b) for a, b in zip(got, ref)]
        t_err = max(d for d, _ in errs)
        t_ok = all(d <= GENE_TAIL_RTOL * sc + GENE_TAIL_ATOL
                   for d, sc in errs)
        del got, ref, plain
        pms = cuda_ms(lambda: gene_stats.gene_partials(Gb, bounds), reps)
        with full_f32_matmul():
            pplain = cuda_ms(lambda: gene_stats.gene_partials_plain(
                Gb, bounds), reps)
        tms = cuda_ms(lambda: gene_stats.gene_stats_tail(
            *part, sizes, wgts, bi, bw, lam), reps)
        tplain = cuda_ms(lambda: gene_stats.gene_stats_tail_plain(
            *part, sizes, wgts, bi, bw, lam), reps)
        # a bucket's launch is shorter than its host path: its time on the
        # device alone too (None when the profiler keeps no record)
        pdev = device_ms(lambda: gene_stats.gene_partials(Gb, bounds)).ms
        tdev = device_ms(lambda: gene_stats.gene_stats_tail(
            *part, sizes, wgts, bi, bw, lam)).ms
        # partials: the block's real columns read once, the outputs written
        # once; int8 multiply-adds of the Gram's lower triangle
        p_ops = 2.0 * B * npad * (npad + 1) / 2 * cols
        p_bytes = B * npad * cols + 4.0 * P * B * npad * (npad + 2)
        # tail: the partials, ids and Wz read once, CovU / WWt / U written
        t_flops = tail_flops(P, B, npad, wgts is None)
        t_bytes = (4.0 * P * B * npad * (npad + 2) + 60.0 * B * npad
                   + 8.0 * 78 * B)
        for k, ms, dms, plain_ms, err, ops, nb, peak in (
                ("gene_partials", pms, pdev, pplain, p_err, p_ops, p_bytes,
                 INT8_OPS_PER_S),
                ("gene_stats_tail", tms, tdev, tplain, t_err, t_flops,
                 t_bytes, FP64_FLOPS_PER_S)):
            r = rows[k]
            b_ms = max(ops / peak, nb / HBM_BYTES_PER_S) * 1e3
            r["ms"] += ms
            r["plain_ms"] += plain_ms
            r["bound_ms"] += b_ms
            r["device_ms"] = (None if dms is None or r["device_ms"] is None
                              else r["device_ms"] + dms)
            r["ops"] += ops
            r["n_bytes"] += nb
            r["max_abs_err"] = max(r["max_abs_err"], err)
            r["buckets"].append(dict(npad=npad, B=B, ms=ms, device_ms=dms,
                                     plain_ms=plain_ms, bound_ms=b_ms))
        log(f"gene kernels {label} bucket npad={npad} B={B} P={P} "
            f"({cols} columns): gene_partials bit-equal={p_equal} "
            f"{pms:.4f} ms per call, {fmt_ms(pdev)} on the device (plain "
            f"{pplain:.3f} ms); gene_stats_tail CorG bit-equal={corr_equal},"
            f" CovU/WWt/U max abs err {t_err:.3e} (rtol {GENE_TAIL_RTOL:g}, "
            f"atol {GENE_TAIL_ATOL:g} normwise) {tms:.4f} ms per call, "
            f"{fmt_ms(tdev)} on the device (plain {tplain:.3f} ms)")
        if not (p_equal and corr_equal and t_ok):
            raise AssertionError(f"gene kernels {label} (npad {npad}) "
                                 f"disagree with their plain versions")
        del Gb, part
    for k, r in rows.items():
        peak = INT8_OPS_PER_S if k == "gene_partials" else FP64_FLOPS_PER_S
        r["bound_by"] = ("operations" if r["ops"] / peak
                         >= r["n_bytes"] / HBM_BYTES_PER_S else "bytes")
        log(f"{k} {label}, {len(buckets)} buckets (one jepeg_region's "
            f"work): kernel {r['ms']:.4f} ms per call (CUDA events), "
            f"{fmt_ms(r['device_ms'])} on the device alone "
            f"(torch.profiler), bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}: {r['n_bytes'] / 1e6:.1f} MB, "
            f"{r['ops'] / 1e9:.3f} G{'OP int8' if k == 'gene_partials' else 'FLOP f64'}) "
            f"= {r['bound_ms'] / r['ms']:.1%} of bound; the torch passes it "
            f"replaced (plain) {r['plain_ms']:.3f} ms")
    torch.cuda.empty_cache()
    return rows


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def phase_jepeg(engine, reps=GENE_REPS):
    """prepare_genes -> jepeg_region on the main path's store and input:
    jepegmix with the main path's weights, then jepeg on one population,
    jepeg_region twice each (K2 once per bucket, gene_partials once per
    bucket, gene_stats_tail once per bucket); every gene against a CPU
    engine's run; each kernel against its plain version on the path's
    own buckets; torch.profiler's kernel count per jepeg_region."""
    store = engine.store
    inp = make_bench_input(store, MEASURED_FRAC)
    annot = gene_annotation(store.index, CACHE)
    cpu = GenomeEngine(store, device="cpu")
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}
    total = collections.Counter()
    out = {}
    for mode, kw in (("jepegmix", dict(pop_wgt=pop_wgt)),
                     ("jepeg", dict(study_pop=STUDY_POP))):
        reset_counts()
        t = time.perf_counter()
        pg = engine.prepare_genes(inp, annot, **kw)
        prep_s = time.perf_counter() - t
        t = time.perf_counter()
        res = pg.jepeg_region()
        first_s = time.perf_counter() - t
        res = pg.jepeg_region()
        launches = read_counts()
        panel = pg._device_panel()
        gsel = pg._select(None, None)
        idx, Ws, zs = pg._gene_inputs(gsel)
        buckets = genekernels._buckets([len(g) for g in idx],
                                       panel.shape[1], 1 << 26)
        nb = len(buckets)
        log(f"jepeg ({mode}): {len(gsel)} genes ({len(pg.zs)} gene SNPs), "
            f"{nb} buckets (sizes "
            f"{[(npad, len(b)) for npad, b in buckets]}), panel "
            f"{tuple(panel.shape)} on the card; launches during "
            f"jepeg_region x2: {launches}")
        if launches["gather_rows"] < 2 * nb:
            raise AssertionError("K2 was not launched once per gene bucket")
        if launches["gene_partials"] != 2 * nb or \
                launches["gene_stats_tail"] != 2 * nb or \
                launches["gene_corr"]:
            raise AssertionError("the gene kernels were not launched once "
                                 "per gene bucket each, the tail in its "
                                 "statistics mode")
        total.update(launches)

        stats = lambda: genekernels.gene_stats_resident(
            panel, idx, Ws, zs, pg.pop_sizes, pg.wgts,
            lam=engine.settings.lambda_)
        dev_ms = cuda_ms(stats, reps)
        wall = host_wall(pg.jepeg_region, reps)
        prof = device_ms(pg.jepeg_region, reps=1)
        names = {k: round(n) for k, n in prof.counts.items()}
        n_kernels = None if prof.ms is None else sum(names.values())
        n_copies = None if prof.ms is None else round(prof.copies)
        t = time.perf_counter()
        ref = cpu.prepare_genes(inp, annot, **kw).jepeg_region()
        cpu_s = time.perf_counter() - t
        rel, same = gene_frames_agree(res, ref)
        tested = int((res["df"] > 0).sum())
        log(f"jepeg ({mode}): prepare_genes {prep_s:.2f}s; first "
            f"jepeg_region (incl. panel upload) {first_s:.3f}s; gene stats "
            f"on the card {dev_ms:.3f} ms (CUDA events, median of {reps}); "
            f"jepeg_region {wall * 1e3:.1f} ms wall (median of {reps}) -> "
            f"{len(gsel) / wall:.1f} genes/s ({tested} tested); vs the CPU "
            f"engine ({cpu_s:.1f}s): max rel diff of chisq and p-values "
            f"{rel:.3e} (tol {GENE_RTOL:g}), df/geneid/top_categ/top_snp "
            f"equal={same}")
        if n_kernels is None:
            log(f"jepeg ({mode}): kernels per jepeg_region not measured "
                f"(torch.profiler kept no device record)")
        else:
            log(f"jepeg ({mode}): torch.profiler over one jepeg_region: "
                f"{n_kernels} CUDA kernels ({n_kernels / nb:.1f} per bucket,"
                f" limit {GENE_KERNELS_PER_BUCKET}), {n_copies} copies / "
                f"sets; by kernel {names}")
        if not (rel <= GENE_RTOL and same and tested > 0):
            raise AssertionError(f"jepeg ({mode}) on the card disagrees "
                                 f"with the CPU engine")
        if n_kernels is not None and \
                n_kernels > GENE_KERNELS_PER_BUCKET * nb:
            raise AssertionError(f"jepeg ({mode}): {n_kernels} CUDA kernels "
                                 f"for {nb} buckets")
        ids = genekernels._bucket_rows(buckets, idx)
        out[mode] = dict(ms=dev_ms, wall_s=wall, genes=len(gsel),
                         buckets=nb, max_rel=rel, frame=res,
                         kernels_per_call=n_kernels,
                         k2=k2_check(f"jepeg {mode} buckets", panel, ids),
                         **gene_checks(f"jepeg {mode}", panel, buckets, idx,
                                       Ws, zs, pg.pop_sizes, pg.wgts,
                                       engine.settings.lambda_))
    return dict(total), out, annot


def impute_diff(got, ref, what):
    """(max|dz|, max|dinfo|, bit-equal, max|dz| / max(1, |z|)) of two
    impute frames that must hold the same rows."""
    for c in ("rsid", "bp", "type"):
        if len(got) != len(ref) or not np.array_equal(got[c].to_numpy(),
                                                      ref[c].to_numpy()):
            raise AssertionError(f"{what}: rows differ ({len(got)} vs "
                                 f"{len(ref)}, column {c})")
    gz, rz = got["z"].to_numpy(), ref["z"].to_numpy()
    gi, ri = got["info"].to_numpy(), ref["info"].to_numpy()
    if not (np.isfinite(gz).all() and np.isfinite(gi).all()):
        raise AssertionError(f"{what}: non-finite z or info")
    dz = np.abs(gz - rz)
    return (float(dz.max()), float(np.abs(gi - ri).max()),
            bool(np.array_equal(gz, rz) and np.array_equal(gi, ri)),
            float((dz / np.maximum(1.0, np.abs(rz))).max()))


def hold_same(got, ref, what, exact=False, tol=SAME_TOL):
    """impute_diff held to ``tol``, or with ``exact`` (the same windows
    in batches of the same size) to bit-equality; returns its log text."""
    dz, dinfo, equal, rel = impute_diff(got, ref, what)
    if exact and not equal:
        raise AssertionError(f"{what}: not bit-equal (max|dz| {dz:.3e}, "
                             f"max|dinfo| {dinfo:.3e})")
    if not (dz <= tol and dinfo <= tol):
        raise AssertionError(f"{what}: max|dz| {dz:.3e}, max|dinfo| "
                             f"{dinfo:.3e} above {tol:g}")
    return (f"max|dz| {dz:.3e} ({rel / 2.0 ** -23:.1f} f32 steps of "
            f"max(1, |z|)), max|dinfo| {dinfo:.3e} "
            f"({'held to bit-equality' if exact else f'tol {tol:g}'}), "
            f"bit-equal={equal}")


def timed_run(runner, dev, **kw):
    """runner.run(**kw) with the launch counts and the peak-memory mark
    set to 0 just before: (stats, wall s, counts, peak bytes).  ``dev``:
    a device, or a mesh's distinct devices, whose peaks are summed."""
    devs = dev if isinstance(dev, list) else [dev]
    reset_counts()
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
    t = time.perf_counter()
    stats = runner.run(**kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return stats, wall, read_counts(), sum(torch.cuda.max_memory_allocated(d)
                                           for d in devs)


def log_run(label, runner, stats, wall, counts, peak, n_units, unit):
    log(f"runner {label}: {len(runner.chunks)} chunks {stats}, wall "
        f"{wall:.3f}s -> {n_units / wall:.1f} {unit}/s ({n_units} {unit}), "
        f"{len(runner.chunks) / wall:.2f} chunks/s; per-chunk elapsed "
        f"{[round(c.elapsed, 4) for c in runner.chunks.values()]} s; "
        f"launches {counts}; peak device memory {peak / 2**30:.2f} GiB")


def all_done(runner, stats, what):
    n = len(runner.chunks)
    if stats != {"done": n, "failed": 0, "skipped": 0} or \
            runner.status() != {"pending": 0, "done": n, "failed": 0}:
        raise AssertionError(f"{what}: {stats}, {runner.status()}; first "
                             f"error: " + next((c.error for c in
                                                runner.chunks.values()
                                                if c.error), "none"))


def runner_maker(engine, lo, hi, tmp):
    """(make, n_windows, chunk_bp): make(name, end_bp=hi, **kw) plans a
    GenomeRunner over [lo, end_bp] of the bench region in chunks of whole
    windows, in its own directory under ``tmp``."""
    store = engine.store
    inp = make_bench_input(store, MEASURED_FRAC)
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}
    n_windows = -(-(hi - lo + 1) // WINDOW_BP)
    chunk_bp = max(1, n_windows // RUNNER_CHUNKS) * WINDOW_BP

    def make(name, end_bp=hi, **kw):
        r = GenomeRunner(os.path.join(tmp, name), engine, inp, pop_wgt,
                         window_bp=WINDOW_BP, wing_size=WING_BP,
                         chunk_bp=chunk_bp, **kw)
        r.plan(22, lo, end_bp)
        return r

    return make, n_windows, chunk_bp


def phase_runner(engine, res, lo, hi, tmp):
    """GenomeRunner over the bench region on the main path's engine,
    analysis "impute": against phase 3's whole-region frame, then resume
    and an injected failure; K1 and K2 against their plain versions on
    one chunk's batch.  Returns the counts, the run's prepared state
    (phase_window's) and the kernel checks."""
    dev = engine.device
    make, n_windows, chunk_bp = runner_maker(engine, lo, hi, tmp)
    by_path = {}
    r = make("impute")
    n = len(r.chunks)
    if n_windows >= 5 * RUNNER_CHUNKS and n < 5:
        raise AssertionError(f"{n} chunks over {n_windows} windows")
    stats, wall, counts, peak = timed_run(r, dev)
    by_path["runner"] = counts
    all_done(r, stats, "runner impute")
    got = r.collect()
    log_run("impute", r, stats, wall, counts, peak,
            int((got["type"] == 0).sum()), "imputed SNPs")
    if counts["weighted_gram_t1"] < 2 * n or counts["gather_rows"] < 2:
        raise AssertionError("the runner's chunks did not launch K1 twice "
                             "each and K2")
    log(f"runner impute: {n} chunks of {chunk_bp // WINDOW_BP} windows "
        f"against phase 3's whole-region call ({len(res)} rows): "
        + hold_same(got, res, "runner collect() vs impute_region"))
    by_path["runner frame"] = got

    # one chunk apart, on the run's own prepared state: its batch build,
    # the region call on the built batch, its kernels on the card
    prep = r._prepared()
    chunks = list(r.chunks.values())
    later = sum(c.elapsed for c in chunks[1:])
    cs = chunks[min(1, n - 1)]
    prep._res.clear()
    torch.cuda.synchronize()
    t = time.perf_counter()
    b = prep._region_batch(cs.start_bp, cs.end_bp, WINDOW_BP, WING_BP)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    region_s = host_wall(lambda: prep.impute_region(
        cs.start_bp, cs.end_bp, window_bp=WINDOW_BP, wing_size=WING_BP))
    fn = prep._kernel_fn("impute", b.Mp, b.Up)
    dev_ms = cuda_ms(lambda: fn(*b.arrays, *b.inputs, *b.compact), 5)
    log(f"runner impute: the chunks after the first took {later:.3f}s = "
        f"{later / max(n - 1, 1) * 1e3:.1f} ms per chunk (the whole run, "
        f"join and panel upload included: {wall:.3f}s); chunk {cs.key} "
        f"({len(b.plans)} windows, Mp={b.Mp}, Up={b.Up}): batch build "
        f"{build_s * 1e3:.1f} ms, impute_region on the built batch "
        f"{region_s * 1e3:.1f} ms wall (median of 3), its kernels "
        f"{dev_ms:.3f} ms on the card (CUDA events, median of 5); the "
        f"rest of a chunk is its shard write and the manifest's")
    checks = {"runner": batch_checks(f"runner chunk {cs.key}", prep, b)}
    del b

    # resume: a new runner over the same directory skips every chunk
    r2 = make("impute")
    stats, wall, counts, _ = timed_run(r2, dev, resume=True)
    log(f"runner impute, resumed by a new runner: {stats}, {wall:.3f}s, "
        f"launches {counts}")
    if stats != {"done": 0, "failed": 0, "skipped": n} or \
            counts["weighted_gram_t1"] or counts["gather_rows"]:
        raise AssertionError("the resumed run did not skip every chunk")

    # one chunk made to fail at dispatch: recorded against it, the others
    # finish, a resume retries it alone
    rf = make("impute_fail")
    victim = list(rf.chunks)[min(2, n - 1)]
    real = rf._prepared
    armed = [True]

    def flaky(cs=None):
        run = real(cs)
        if cs.key == victim and armed:
            armed.clear()
            raise RuntimeError("injected chunk failure")
        return run

    rf._prepared = flaky
    stats, wall, counts, _ = timed_run(rf, dev)
    failed = [c for c in rf.chunks.values() if c.status == "failed"]
    log(f"runner impute with chunk {victim} made to fail: {stats}; failed "
        f"{[c.key for c in failed]}: "
        f"{failed[0].error.splitlines()[0] if failed else None}")
    if stats != {"done": n - 1, "failed": 1, "skipped": 0} or \
            [c.key for c in failed] != [victim] or \
            "injected chunk failure" not in failed[0].error:
        raise AssertionError("the failure was not recorded against its "
                             "own chunk alone")
    del rf._prepared
    stats, wall, counts2, _ = timed_run(rf, dev, resume=True)
    log(f"runner impute, failed chunk resumed: {stats}, launches {counts2}; "
        f"against the first run: "
        + hold_same(rf.collect(), got, "resumed run vs first run",
                    exact=True))
    if stats != {"done": 1, "failed": 0, "skipped": n - 1} or \
            counts2["weighted_gram_t1"] < 2 or \
            (n > 1 and counts2["weighted_gram_t1"]
             >= by_path["runner"]["weighted_gram_t1"]):
        raise AssertionError("the resume did not retry the failed chunk "
                             "alone")
    return by_path, prep, checks, by_path.pop("runner frame")


def phase_runner_analyses(engine, lo, hi, tmp, ld_ref, qcat_ref, gene_ref,
                          annot):
    """One GenomeRunner run each of analysis "qcat", "ld" and "jepeg" on
    the main path's engine, against the engine calls of phases 7, 6 and
    8 (ld over the first LD_CHUNKS chunks only)."""
    dev = engine.device
    make, _, chunk_bp = runner_maker(engine, lo, hi, tmp)
    by_path, checks = {}, {}

    # qcat: phase 7's qcat_region over the whole region
    rq = make("qcat", analysis="qcat")
    n = len(rq.chunks)
    stats, wall, counts, peak = timed_run(rq, dev)
    by_path["runner qcat"] = counts
    all_done(rq, stats, "runner qcat")
    q = rq.collect()
    log_run("qcat", rq, stats, wall, counts, peak, len(q), "tested SNPs")
    same = len(q) == len(qcat_ref) and all(
        np.array_equal(q[c].to_numpy(), qcat_ref[c].to_numpy())
        for c in ("rsid", "bp", "type", "qcat_m"))
    dr = float("inf")
    if same:
        dt = q["qcat_t"].to_numpy() - qcat_ref["qcat_t"].to_numpy()
        dr = float(np.abs(
            dt / np.sqrt(qcat_ref["qcat_m"].to_numpy() - 3.0)).max())
    log(f"runner qcat against phase 7's qcat_region: rows and qcat_m "
        f"equal={same}, max|dr| {dr:.3e} (tol {SAME_TOL:g}), bit-equal="
        f"{same and bool(np.array_equal(q['qcat_t'], qcat_ref['qcat_t']))}")
    if not (same and dr <= SAME_TOL) or counts["weighted_gram_t1"] < 2 * n:
        raise AssertionError("runner qcat disagrees with qcat_region")
    # the kernels on one chunk's batch (the run's prepared state)
    cs = list(rq.chunks.values())[min(1, n - 1)]
    prep = rq._prepared()
    checks["runner qcat"] = batch_checks(
        f"runner qcat chunk {cs.key}", prep,
        prep._region_batch(cs.start_bp, cs.end_bp, WINDOW_BP, WING_BP))
    del rq, prep
    torch.cuda.empty_cache()

    # ld: phase 6's ld_region (the default i16tri fetch), over a
    # sub-span to keep the script short: the first LD_CHUNKS chunks
    ld_hi = min(hi, lo + LD_CHUNKS * chunk_bp - 1)
    rl = make("ld", end_bp=ld_hi, analysis="ld")
    stats, wall, counts, peak = timed_run(rl, dev)
    by_path["runner ld"] = counts
    all_done(rl, stats, "runner ld")
    blocks = rl.collect_ld()
    log_run(f"ld (a sub-span: the first {len(rl.chunks)} of {n} chunks)",
            rl, stats, wall, counts, peak, len(blocks), "windows")
    ld_ref = [d for d in ld_ref if d["snplist"]["bp"].iloc[0] <= ld_hi]
    if len(blocks) != len(ld_ref) or \
            counts["weighted_gram_t1"] < len(rl.chunks):
        raise AssertionError(f"runner ld: {len(blocks)} windows, ld_region "
                             f"{len(ld_ref)}")
    ld_dr, ld_equal = 0.0, True
    for b, d in zip(blocks, ld_ref):
        if list(b["snplist"]["rsid"]) != list(d["snplist"]["rsid"]) or \
                set(b["snplist"]["fetch"]) != {d["fetch"]}:
            raise AssertionError("runner ld: a window's SNPs or fetch mode "
                                 "differ")
        ld_dr = max(ld_dr, float(np.nanmax(np.abs(b["cormat"]
                                                  - d["cormat"]))))
        ld_equal &= bool(np.array_equal(b["cormat"], d["cormat"],
                                        equal_nan=True))
    ld_tol = 2 * LD_I16_MAX_ERR + SAME_TOL
    log(f"runner ld against phase 6's ld_region (i16tri): max|dr| "
        f"{ld_dr:.3e} (tol {ld_tol:.3e}: each side within "
        f"LD_I16_MAX_ERR of its f32 value, one int16 step apart at "
        f"most), bit-equal={ld_equal}")
    if not ld_dr <= ld_tol:
        raise AssertionError("runner ld disagrees with ld_region")
    # the kernels on the last chunk's LD launch and on the gather of the
    # measured half it read
    cs = list(rl.chunks.values())[-1]
    prep = rl._prepared()
    _, args, Mp = prep._ld_batch(
        prep._ld_windows(cs.start_bp, cs.end_bp, WINDOW_BP), "i16tri")
    checks["runner ld"] = {
        "weighted_gram_t1": k1_check(
            f"runner ld chunk {cs.key} mm",
            (args[0], args[0], *segments(prep), args[3], args[3], Mp, Mp,
             True), 3),
        "gather_rows": k2_check(
            "runner ld measured half", prep._device_panel(),
            prep._half_rows(1, prep._res[("half", 1)][0]), 3,
            device_too=False)}
    del rl, blocks, prep, args
    torch.cuda.empty_cache()

    # jepeg: phase 8's jepegmix genes, partitioned by their first SNP
    rj = make("jepeg", analysis="jepeg", annot_df=annot)
    stats, wall, counts, peak = timed_run(rj, dev)
    by_path["runner jepeg"] = counts
    all_done(rj, stats, "runner jepeg")
    genes = rj.collect()
    log_run("jepeg", rj, stats, wall, counts, peak, len(genes), "genes")
    rel, same = gene_frames_agree(genes, gene_ref)
    log(f"runner jepeg against phase 8's jepeg_region: max rel diff "
        f"{rel:.3e} (tol {GENE_RTOL:g}), df/geneid/top_categ/top_snp "
        f"equal={same}")
    if not (rel <= GENE_RTOL and same) or counts["gather_rows"] < 1 or \
            counts["gene_partials"] < 1 or \
            counts["gene_partials"] != counts["gene_stats_tail"] or \
            counts["gene_corr"]:
        raise AssertionError("runner jepeg disagrees with jepeg_region or "
                             "did not launch the gene kernels once per "
                             "bucket, the tail in its statistics mode")
    # K2 on the gene buckets of one chunk (genes by their first SNP)
    pg = rj._prepared()
    cs = max(rj.chunks.values(),
             key=lambda c: len(pg._select(c.start_bp, c.end_bp)))
    idx = pg._gene_inputs(pg._select(cs.start_bp, cs.end_bp))[0]
    panel = pg._device_panel()
    buckets = genekernels._buckets([len(g) for g in idx], panel.shape[1],
                                   1 << 26)
    checks["runner jepeg"] = {"gather_rows": k2_check(
        f"runner jepeg chunk {cs.key}, {len(idx)} genes in {len(buckets)} "
        f"bucket(s)", panel, genekernels._bucket_rows(buckets, idx), 3,
        device_too=False)}
    return by_path, checks


def phase_stream(store, dev, tmp):
    """The runner in streaming mode on bgzf files of the store's first
    STREAM_SNPS SNPs, against the resident runner on the decoded files."""
    n = min(STREAM_SNPS, len(store.index))
    t = time.perf_counter()
    pf = PanelFiles(*write_panel(os.path.join(tmp, "stream"), store.desc,
                                 store.index.iloc[:n], store.G[:n],
                                 store.af[:n], level=STREAM_ZLIB_LEVEL))
    write_s = time.perf_counter() - t
    lo = int(store.index["bp"].iloc[0])
    hi = int(store.index["bp"].iloc[n - 1])
    n_windows = -(-(hi - lo + 1) // WINDOW_BP)
    chunk_bp = (2 if n_windows >= 4 else 1) * WINDOW_BP
    zin = make_bench_input(store, MEASURED_FRAC)
    zin = zin[zin["bp"] <= hi + WING_BP]
    zfile = os.path.join(tmp, "stream_z.txt")
    with open(zfile, "w") as fh:
        fh.write("rsid chr bp a1 a2 z\n")
        for row in zin.itertuples(index=False):
            fh.write(f"{row.rsid} {row.chr} {row.bp} {row.a1} {row.a2} "
                     f"{row.z!r}\n")
    inp = readers.read_input_z(zfile, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=WING_BP)
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}
    t = time.perf_counter()
    decoded = PanelStore.from_bgzf(pf, chrom=22)
    decode_s = time.perf_counter() - t
    log(f"stream: wrote {n} SNPs x {store.G.shape[1]} subjects as bgzf "
        f"({os.path.getsize(pf.data_file) / 2**20:.1f} MiB at zlib level "
        f"{STREAM_ZLIB_LEVEL}) in {write_s:.1f}s with the Python writer; "
        f"whole file decoded in "
        f"{decode_s:.2f}s; dosages equal="
        f"{bool(np.array_equal(decoded.G, store.G[:n]))}; {len(inp)} "
        f"measured SNPs, {n_windows} windows, chunks of "
        f"{chunk_bp // WINDOW_BP}")
    if not np.array_equal(decoded.G, store.G[:n]):
        raise AssertionError("the decoded panel differs from the store")

    def make(name, engine, **kw):
        r = GenomeRunner(os.path.join(tmp, name), engine, inp, pop_wgt,
                         window_bp=WINDOW_BP, wing_size=WING_BP,
                         chunk_bp=chunk_bp, **kw)
        r.plan(22, lo, hi)
        return r

    rr = make("stream_resident",
              GenomeEngine(decoded, device=dev, device_linalg=True))
    stats, wall, counts, peak = timed_run(rr, dev)
    all_done(rr, stats, "resident runner on the decoded files")
    ref = rr.collect()
    log_run("impute, resident on the decoded files", rr, stats, wall,
            counts, peak, int((ref["type"] == 0).sum()), "imputed SNPs")
    del rr
    torch.cuda.empty_cache()

    tracer = Tracer()
    rs = make("stream", GenomeEngine(None, device=dev, device_linalg=True),
              panel_files=pf, tracer=tracer)
    if n == STREAM_SNPS and (len(rs.chunks) < 2 or chunk_bp < 2 * WINDOW_BP):
        raise AssertionError("streaming needs 2 chunks of 2 windows")
    stats, wall, counts, peak = timed_run(rs, dev)
    all_done(rs, stats, "streaming runner")
    got = rs.collect()
    log_run("impute, streaming", rs, stats, wall, counts, peak,
            int((got["type"] == 0).sum()), "imputed SNPs")
    decodes = [p for p in tracer.phases if p.name.endswith("decode_chunk")]
    prepares = [p for p in tracer.phases if p.name.endswith("prepare_chunk")]
    log(f"stream: decode_chunk {[round(p.elapsed, 3) for p in decodes]} s, "
        f"prefetched {[p.meta['prefetched'] for p in decodes]}; "
        f"prepare_chunk {[round(p.elapsed, 3) for p in prepares]} s; "
        f"against the resident runner: "
        + hold_same(got, ref, "streaming vs resident runner", exact=True)
        + f", max|d af1mix| "
        f"{float(np.abs(got['af1mix'] - ref['af1mix']).max()):.1e} (a "
        f"float64 product over another number of rows)")
    if len(decodes) != len(rs.chunks) or decodes[0].meta["prefetched"] or \
            not all(p.meta["prefetched"] for p in decodes[1:]) or \
            counts["weighted_gram_t1"] < 2 * len(rs.chunks) or \
            counts["gather_rows"] < 2 * len(rs.chunks):
        raise AssertionError("streaming: a chunk after the first was not "
                             "prefetched, or a chunk launched no kernel")
    # the kernels on the last chunk's batch: its own decoded store, its
    # own device panel (decoded and prepared again as the run did)
    cs = list(rs.chunks.values())[-1]
    prep = rs._prepared(cs)
    checks = batch_checks(
        f"streaming chunk {cs.key}", prep,
        prep._region_batch(cs.start_bp, cs.end_bp, WINDOW_BP, WING_BP))
    del prep, rs
    torch.cuda.empty_cache()
    return counts, checks, pf, zfile, inp, pop_wgt, lo, hi, chunk_bp, ref


def read_tsv(path):
    return pd.read_csv(path, sep="\t", float_precision="round_trip")


def phase_cli(dev, tmp, pf, zfile, inp, pop_wgt, lo, hi, chunk_bp,
              runner_ref):
    """The command line in-process with its default --device, on a
    panel-cache of phase 11's files, each output against the Python
    call's."""
    ref_args = ["--reference-index-file", pf.index_file,
                "--reference-data-file", pf.data_file,
                "--reference-pop-desc-file", pf.pop_desc_file]
    cache = os.path.join(tmp, "cache")
    cli.main(["panel-cache", "--chr", "22", "-o", cache] + ref_args)
    wgt = os.path.join(tmp, "wgt.tsv")
    pd.DataFrame({"pop": list(pop_wgt), "wgt": list(pop_wgt.values())}
                 ).to_csv(wgt, sep="\t", index=False)
    span = ["--chr", "22", "--start-bp", str(lo), "--end-bp", str(hi),
            "--pop-wgt-file", wgt, "--input-file", zfile,
            "--window-bp", str(WINDOW_BP), "--wing-size", str(WING_BP),
            "--panel-cache", cache] + ref_args
    by_path = {}

    def call(argv, out):
        reset_counts()
        t = time.perf_counter()
        cli.main(argv + ["-o", out])
        torch.cuda.synchronize()
        return read_counts(), time.perf_counter() - t

    genome = ["impute-genome"] + span + [
        "--chunk-bp", str(chunk_bp), "--run-dir", os.path.join(tmp, "cli_run")]
    out1, out2 = os.path.join(tmp, "g1.tsv"), os.path.join(tmp, "g2.tsv")
    by_path["cli impute-genome"], wall = call(genome, out1)
    c2, wall2 = call(genome, out2)
    g1 = read_tsv(out1)
    log(f"cli impute-genome: {wall:.3f}s, launches "
        f"{by_path['cli impute-genome']}; again (resumes): {wall2:.3f}s, "
        f"launches {c2}, the same file="
        f"{open(out1).read() == open(out2).read()}; against the Python "
        f"runner on the same chunks: "
        + hold_same(g1, runner_ref, "cli impute-genome vs GenomeRunner",
                    exact=True))
    if by_path["cli impute-genome"]["weighted_gram_t1"] < 2 or \
            by_path["cli impute-genome"]["gather_rows"] < 2 or \
            c2["weighted_gram_t1"] or c2["gather_rows"] or \
            open(out1).read() != open(out2).read():
        raise AssertionError("cli impute-genome: no kernel on the first "
                             "call, or the second did not resume")
    buf = io.StringIO()      # --status prints the counts on stdout
    with contextlib.redirect_stdout(buf):
        cli.main(genome + ["--status"])
    status = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"cli impute-genome --status: {status}")
    if status.get("done", 0) < 1 or status.get("failed") or \
            status.get("pending"):
        raise AssertionError("cli --status does not show the run done")

    store = PanelStore.load(cache)
    # the kernels on the batch of impute-genome's first chunk, built as
    # the command builds it: the cached store, the default AF cut-off
    checks = {}
    run = GenomeEngine(store, device=dev, device_linalg=True).prepare_mix(
        inp, pop_wgt, af1_cutoff=0.01)
    checks["cli impute-genome"] = batch_checks(
        "cli impute-genome, first chunk", run,
        run._region_batch(lo, min(lo + chunk_bp - 1, hi), WINDOW_BP,
                          WING_BP))
    del run
    for cmd, extra, cutoff, method in (
            ("impute-region", ["--device-linalg"], 0.01, "impute_region"),
            ("qcat-region", [], 0.05, "qcat_region")):
        out = os.path.join(tmp, cmd + ".tsv")
        by_path["cli " + cmd], wall = call([cmd] + span + extra, out)
        got = read_tsv(out)
        run = GenomeEngine(store, device=dev, device_linalg=True
                           ).prepare_mix(inp, pop_wgt, af1_cutoff=cutoff)
        ref = getattr(run, method)(lo, hi, window_bp=WINDOW_BP,
                                   wing_size=WING_BP)
        checks["cli " + cmd] = batch_checks(
            "cli " + cmd, run,
            run._region_batch(lo, hi, WINDOW_BP, WING_BP))
        del run
        if cmd == "impute-region":
            text = hold_same(got, ref, "cli impute-region vs impute_region",
                             exact=True)
        else:
            same = len(got) == len(ref) and all(
                np.array_equal(got[c].to_numpy(), ref[c].to_numpy())
                for c in ("rsid", "bp", "type", "qcat_m"))
            dt = float(np.abs(got["qcat_t"].to_numpy()
                              - ref["qcat_t"].to_numpy()).max()
                       ) if same else float("inf")
            text = (f"rows and qcat_m equal={same}, max|dt| {dt:.3e} (held "
                    f"to 0: batches of the same size)")
            if not (same and dt == 0.0):
                raise AssertionError("cli qcat-region disagrees with "
                                     "qcat_region")
        log(f"cli {cmd}: {wall:.3f}s, {len(got)} rows, launches "
            f"{by_path['cli ' + cmd]}; against the Python call: {text}")
        if by_path["cli " + cmd]["weighted_gram_t1"] < 2 or \
                by_path["cli " + cmd]["gather_rows"] < 1:
            raise AssertionError(f"cli {cmd} launched no kernel")
    return by_path, checks


def phase_window(prep, res, lo, hi, first_host):
    """impute_window with device_linalg (a one-window region on the card)
    on the first, middle and last window of the bench region: against the
    float64 host window and against its rows of phase 3's region call."""
    spans = []
    a = lo
    while a <= hi:
        b = min(a + WINDOW_BP - 1, hi)
        if prep._window_plan(a, b, WING_BP) is not None:
            spans.append((a, b))
        a = b + 1
    reset_counts()
    worst = 0.0
    picks = sorted({0, len(spans) // 2, len(spans) - 1})
    for i in picks:
        a, b = spans[i]
        t = time.perf_counter()
        got = prep.impute_window(a, b, WING_BP)
        first_s = time.perf_counter() - t
        wall = host_wall(lambda: prep.impute_window(a, b, WING_BP))
        t = time.perf_counter()
        host = (first_host if i == 0 else
                prep._impute_window_host(a, b, WING_BP).table)
        host_s = time.perf_counter() - t
        dz, dinfo, _, _ = impute_diff(got.table, host,
                                      f"device window {i}")
        imp = host["type"].to_numpy() == 0
        inside = res[(res["bp"] >= a) & (res["bp"] <= b)
                     ].reset_index(drop=True)
        log(f"device impute_window {i} ({got.n_measured} measured, "
            f"{got.n_unmeasured} unmeasured): first call {first_s:.3f}s, "
            f"then {wall * 1e3:.1f} ms wall (median of 3; host float64 "
            f"window {host_s:.1f}s); vs the float64 host window max|dZ| "
            f"{dz:.3e} (tol {DZ_TOL:g}), max|dInfo| {dinfo:.3e}, measured "
            f"rows bit-equal="
            f"{bool(np.array_equal(got.table['z'][~imp], host['z'][~imp]))}"
            f"; vs its rows of the region call: "
            + hold_same(got.table, inside, f"device window {i} vs region"))
        if not dz <= DZ_TOL:
            raise AssertionError(f"device window {i} disagrees with the "
                                 f"host path")
        worst = max(worst, dz)
    counts = read_counts()
    log(f"device impute_window: launches over {len(picks)} windows x 4 "
        f"calls {counts}")
    # the kernels on the middle window's own one-window batch
    a, b = spans[picks[len(picks) // 2]]
    checks = batch_checks(
        f"impute_window {picks[len(picks) // 2]}", prep,
        prep._region_batch(a, b, b - a + 1, WING_BP, slot="window"))
    return counts, worst, checks, (a, b, prep.impute_window(a, b,
                                                             WING_BP).table)


def phase_trace(prep, lo):
    """utils/timing.device_trace around one device impute_window: the
    Chrome trace torch.profiler writes must hold both kernels' records
    from the card."""
    with tempfile.TemporaryDirectory(prefix="gauss_trace_") as tdir:
        with device_trace(tdir):
            prep._res.clear()          # rebuild the batch: K2 runs too
            prep.impute_window(lo, lo + WINDOW_BP - 1, WING_BP)
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(tdir, "trace_*.json"))
        names = {str(e.get("name", "")) for f in files
                 for e in json.load(open(f))["traceEvents"]
                 if e.get("cat") == "kernel"}
        log(f"device_trace: {len(files)} Chrome trace file(s), "
            f"{sum(os.path.getsize(f) for f in files)} bytes, "
            f"{len(names)} distinct kernels on the card")
    for k in ("weighted_gram_kernel", "gather_rows_kernel"):
        if not any(k in n for n in names):
            raise AssertionError(f"device_trace: no {k} record in the trace")


def mesh_region(label, store, inp, pop_wgt, mesh, lo, hi):
    """prepare_mix -> impute_region over ``mesh`` on the bench region:
    (engine, run, frame, launches of that first call, its batch, region
    ms on the card).  The launches must be the formula's: K1 twice per
    slab of every window group's shards, K2 twice per shard of every
    group of an aligned batch (of every distinct group otherwise)."""
    eng = GenomeEngine(store, mesh=mesh)
    t = time.perf_counter()
    run = eng.prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    prep_s = time.perf_counter() - t
    reset_counts()
    t = time.perf_counter()
    got = run.impute_region(lo, hi, window_bp=WINDOW_BP, wing_size=WING_BP)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    counts = read_counts()
    b = run._region_batch(lo, hi, WINDOW_BP, WING_BP)
    n_win, n_sub = mesh.shape["window"], mesh.shape["subject"]
    Wg = b.groups[0].inputs[0].shape[0]
    slabs = Wg // win_slab(Wg)
    want = {"weighted_gram_t1": 2 * n_win * n_sub * slabs,
            "gather_rows": 2 * n_sub * (n_win if b.aligned else
                                        len(set(mesh.groups())))}
    fn = run._kernel_fn("impute", b.Mp, b.Up)
    ms = cuda_ms(lambda: [fn(*g.arrays, *g.inputs, *g.compact)
                          for g in b.groups], 5)
    log(f"mesh {label}: {n_win} window group(s) x {n_sub} subject shard(s) "
        f"on {[str(d) for d in mesh.devices.ravel()]}; prepare_mix "
        f"{prep_s:.1f}s, first impute_region (incl. shard uploads, K2 "
        f"gathers, preparation) {first_s:.3f}s; batch "
        f"{'aligned' if b.aligned else 'shared'}, {len(b.plans)} windows, "
        f"{Wg} per group ({slabs} slab(s)), Mp={b.Mp}, Up={b.Up}, local "
        f"S={sum(eng._padded_sizes(run.pop_sizes))}; launches {counts} "
        f"(formula {want}); region on the card {ms:.3f} ms (CUDA events, "
        f"median of 5)")
    if {k: counts[k] for k in want} != want:
        raise AssertionError(f"mesh {label}: launches {counts}, formula "
                             f"{want}")
    return eng, run, got, counts, b, ms


def mesh_checks(run, b, reps=3):
    """K1 (mm, um) and K2 (both gathers) against their plain versions on
    subject shard 0 of window group 0: its shifted panels, band offsets
    and gathered row ids."""
    g = b.groups[0]
    Xm, Xu = (a[0] if isinstance(a, tuple) else a for a in g.arrays[:2])
    m0, u0 = g.inputs[0], g.inputs[1]
    seg = segments(run)
    s_real = sum(run.engine._spec(run.pop_sizes, run.wgts).valid_counts[0])
    k1 = sum_checks([
        k1_check("mesh shard 0 mm", (Xm, Xm, *seg, m0, m0, b.Mp, b.Mp, True),
                 reps, s_real=s_real),
        k1_check("mesh shard 0 um", (Xu, Xm, *seg, u0, m0, b.Up, b.Mp,
                                     False), reps, s_real=s_real)])
    Wg = m0.shape[0]
    rows_m, rows_u = run._aligned_rows(b.plans[:Wg], Wg, (b.Mp, b.Up))
    panel = run._group_panels()[0][0]
    k2 = sum_checks([
        k2_check("mesh shard 0 measured rows", panel, rows_m, reps,
                 device_too=False),
        k2_check("mesh shard 0 unmeasured rows", panel, rows_u, reps,
                 device_too=False)])
    return {"weighted_gram_t1": k1, "gather_rows": k2}


def mesh_parity(got, host, label):
    """A mesh's first window against phase 5's float64 host window: the
    bar phase 5 holds one device to (TF32_DZ on the imputed rows, the
    measured rows bit-equal); returns its log text."""
    win = got[got["bp"] <= host["bp"].max()].reset_index(drop=True)
    dz, dinfo, _, _ = impute_diff(win, host, f"mesh {label} first window")
    imp = host["type"].to_numpy() == 0
    measured = bool(np.array_equal(win["z"].to_numpy()[~imp],
                                   host["z"].to_numpy()[~imp]))
    if not (dz <= TF32_DZ and measured):
        raise AssertionError(f"mesh {label}: first window max|dZ| {dz:.3e} "
                             f"against the float64 host window (tol "
                             f"{TF32_DZ:g}), measured rows equal={measured}")
    return (f"first window against the float64 host window max|dZ| "
            f"{dz:.3e} (tol {TF32_DZ:g}, as phase 5), max|dInfo| "
            f"{dinfo:.3e}, measured rows bit-equal")


def phase_mesh(dev, store, res, lo, hi, region_ms, refs, tmp, stream):
    """The engine over device meshes on the bench store: 1x1 (bit-equal
    to phase 3), 1x2 and 2x2 over the repeated card (SAME_TOL), the 2x2
    engine's other paths against phases 6-8, 10 and 12, the command line
    with --mesh 1x1, and a mesh over two cards when there are two."""
    t0 = time.perf_counter()
    inp = make_bench_input(store, MEASURED_FRAC)
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}
    by_path, times = {}, {}
    for shape in ((1, 1), (1, 2)):
        label = f"{shape[0]}x{shape[1]}"
        eng, run, got, by_path[f"mesh {label}"], b, times[label] = \
            mesh_region(label, store, inp, pop_wgt,
                        make_mesh(*shape, devices=[dev] * (shape[0]
                                                           * shape[1])),
                        lo, hi)
        log(f"mesh {label} impute_region against phase 3's frame: "
            + hold_same(got, res, f"mesh {label} vs phase 3",
                        exact=shape == (1, 1), tol=MESH_TOL)
            + "; " + mesh_parity(got, refs["first_host"], label))
        del eng, run, got, b
        torch.cuda.empty_cache()

    mesh = make_mesh(2, 2, devices=[dev] * 4)
    eng, run, got, by_path["mesh"], b, times["2x2"] = mesh_region(
        "2x2", store, inp, pop_wgt, mesh, lo, hi)
    log("mesh 2x2 impute_region against phase 3's frame: "
        + hold_same(got, res, "mesh 2x2 vs phase 3", tol=MESH_TOL)
        + "; " + mesh_parity(got, refs["first_host"], "2x2"))
    checks = mesh_checks(run, b)
    slabs = b.groups[0].inputs[0].shape[0] // win_slab(
        b.groups[0].inputs[0].shape[0])
    del got, b
    torch.cuda.empty_cache()

    # qcat on the same windows (the cached batch: K1 alone)
    reset_counts()
    q = run.qcat_region(lo, hi, window_bp=WINDOW_BP, wing_size=WING_BP)
    by_path["mesh qcat"] = counts = read_counts()
    ref = refs["qcat"]
    same = len(q) == len(ref) and all(
        np.array_equal(q[c].to_numpy(), ref[c].to_numpy())
        for c in ("rsid", "bp", "type", "qcat_m"))
    dt = q["qcat_t"].to_numpy() - ref["qcat_t"].to_numpy() if same else 1.0
    dr = float(np.abs(dt / np.sqrt(ref["qcat_m"].to_numpy() - 3.0)).max())
    want = 2 * 4 * slabs
    log(f"mesh 2x2 qcat_region against phase 7's: rows and qcat_m "
        f"equal={same}, max|dr| {dr:.3e} (r = t / sqrt(m - 3), tol "
        f"{SAME_TOL:g}), max|dt| {float(np.abs(dt).max()):.3e}; launches "
        f"{counts} (formula: K1 {want}, K2 0 on impute's cached batch)")
    if not (same and dr <= SAME_TOL) or counts["weighted_gram_t1"] != want \
            or counts["gather_rows"]:
        raise AssertionError("mesh qcat_region disagrees with phase 7")
    del q
    torch.cuda.empty_cache()

    # LD, the default i16tri fetch: one K1 per shard per slab
    reset_counts()
    tri = run.ld_region(lo, hi, window_bp=WINDOW_BP)
    by_path["mesh ld"] = counts = read_counts()
    W = len(tri)
    Wg = group_width(W, 2)
    want = 4 * (Wg // win_slab(Wg))
    ld_dr = max(float(np.nanmax(np.abs(a["cormat"] - d["cormat"])))
                for a, d in zip(tri, refs["ld"]))
    ld_tol = 2 * LD_I16_MAX_ERR + SAME_TOL
    log(f"mesh 2x2 ld_region (i16tri) against phase 6's: {W} windows, "
        f"max|dr| {ld_dr:.3e} (tol {ld_tol:.3e}: one int16 step); launches "
        f"{counts} (K1 formula {want})")
    if W != len(refs["ld"]) or not ld_dr <= ld_tol or \
            counts["weighted_gram_t1"] != want:
        raise AssertionError("mesh ld_region disagrees with phase 6")
    del tri
    torch.cuda.empty_cache()

    # jepegmix genes: exact partials over the shards
    reset_counts()
    genes = eng.prepare_genes(inp, refs["annot"],
                              pop_wgt=pop_wgt).jepeg_region()
    by_path["mesh jepeg"] = counts = read_counts()
    rel, same = gene_frames_agree(genes, refs["genes"], MESH_GENE_RTOL)
    log(f"mesh 2x2 jepegmix against phase 8's: {len(genes)} genes, max "
        f"rel diff {rel:.3e} (tol {MESH_GENE_RTOL:g}), df/geneid/top_categ/"
        f"top_snp equal={same}; launches {counts} (gene_partials once per "
        f"bucket and shard, gene_stats_tail once per bucket and window "
        f"group: 2 x the tail's)")
    if not (rel <= MESH_GENE_RTOL and same) or counts["gather_rows"] < 2 \
            or counts["gene_stats_tail"] < 2 or counts["gene_corr"] \
            or counts["gene_partials"] != 2 * counts["gene_stats_tail"]:
        raise AssertionError("mesh jepeg disagrees with phase 8")
    del genes

    # the middle window alone against phase 12's
    a, c, wref = refs["window"]
    reset_counts()
    w = run.impute_window(a, c, WING_BP).table
    by_path["mesh impute_window"] = counts = read_counts()
    log(f"mesh 2x2 impute_window [{a}, {c}] against phase 12's: "
        + hold_same(w, wref, "mesh impute_window vs phase 12", tol=MESH_TOL)
        + f"; launches {counts}")
    del run
    torch.cuda.empty_cache()

    # two chunks of the runner against phase 10's rows
    make, _, chunk_bp = runner_maker(eng, lo, hi, tmp)
    end = min(hi, lo + 2 * chunk_bp - 1)
    r = make("mesh_runner", end_bp=end)
    stats, wall, counts, peak = timed_run(r, mesh.distinct())
    by_path["mesh runner"] = counts
    all_done(r, stats, "mesh runner")
    got = r.collect()
    log_run("impute over the 2x2 mesh (2 chunks)", r, stats, wall, counts,
            peak, int((got["type"] == 0).sum()), "imputed SNPs")
    ref = refs["runner"]
    ref = ref[ref["bp"] <= end].reset_index(drop=True)
    log("mesh runner against phase 10's rows: "
        + hold_same(got, ref, "mesh runner vs phase 10", tol=MESH_TOL))
    del r, got, eng
    torch.cuda.empty_cache()

    # the command line, --mesh 1x1, on phase 12's panel cache
    pf, zfile, sinp, spop, slo, shi = stream[:6]
    cache = os.path.join(tmp, "cache")
    argv = ["impute-region", "--chr", "22", "--start-bp", str(slo),
            "--end-bp", str(shi), "--pop-wgt-file", os.path.join(tmp,
                                                                 "wgt.tsv"),
            "--input-file", zfile, "--window-bp", str(WINDOW_BP),
            "--wing-size", str(WING_BP), "--panel-cache", cache,
            "--reference-index-file", pf.index_file, "--reference-data-file",
            pf.data_file, "--reference-pop-desc-file", pf.pop_desc_file,
            "--mesh", "1x1", "-o", os.path.join(tmp, "mesh11.tsv")]
    reset_counts()
    cli.main(argv)
    by_path["mesh cli"] = counts = read_counts()
    ref = GenomeEngine(PanelStore.load(cache), mesh=make_mesh(
        1, 1, devices=[dev])).prepare_mix(sinp, spop, af1_cutoff=0.01
                                          ).impute_region(
        slo, shi, window_bp=WINDOW_BP, wing_size=WING_BP)
    log(f"cli impute-region --mesh 1x1 against the Python 1x1 call: "
        + hold_same(read_tsv(os.path.join(tmp, "mesh11.tsv")), ref,
                    "cli --mesh 1x1 vs Python", exact=True)
        + f"; launches {counts}")

    if torch.cuda.device_count() >= 2:
        two = [torch.device("cuda", 0), torch.device("cuda", 1)]
        eng2, _, got, by_path["mesh 2 cards"], _, times["1x2 cards"] = \
            mesh_region("1x2 over two cards", store, inp, pop_wgt,
                        make_mesh(1, 2, devices=two), lo, hi)
        log("mesh 1x2 over two cards against phase 3's frame: "
            + hold_same(got, res, "mesh over two cards vs phase 3",
                        tol=MESH_TOL))
        del eng2, got
        torch.cuda.empty_cache()
    else:
        log(f"mesh over two cards: skipped, this machine has "
            f"{torch.cuda.device_count()} card")
    log("mesh region ms on the card: " + ", ".join(
        f"{k} {v:.3f}" for k, v in times.items())
        + f"; phase 3 (one device) {region_ms:.3f}; phase 13 took "
        f"{time.perf_counter() - t0:.1f}s")
    return by_path, checks, times


def norm_rel(got, ref):
    """Largest normwise relative difference of two results of one
    analysis (frames, dicts of them, arrays): per float column or array,
    max |got - ref| / max |ref| over the entries where ref is finite.
    Elementwise ratios are not used: the card's float64 sqrt is
    correctly rounded and torch's vectorized CPU one is not, so the
    correlation blocks differ by an ulp, the host solve carries that into
    every z, and an imputed z near 0 would make an elementwise ratio of an
    ulp-sized difference arbitrarily large.  Raises if shapes, rows,
    finite positions or other columns differ."""
    if isinstance(ref, dict):
        return max(norm_rel(got[k], ref[k]) for k in ref)
    if isinstance(ref, pd.DataFrame):
        if list(got.columns) != list(ref.columns) or len(got) != len(ref):
            raise AssertionError("columns or rows differ")
        out = 0.0
        for c in ref.columns:
            a, b = got[c].to_numpy(), ref[c].to_numpy()
            if b.dtype.kind == "f":
                out = max(out, norm_rel(a, b))
            elif not np.array_equal(a, b):
                raise AssertionError(f"column {c} differs")
        return out
    a, b = np.asarray(got, dtype=np.float64), np.asarray(ref,
                                                         dtype=np.float64)
    fin = np.isfinite(b)
    if a.shape != b.shape or not np.array_equal(np.isfinite(a), fin) or \
            not np.array_equal(a[~fin], b[~fin], equal_nan=True):
        raise AssertionError("shapes or non-finite entries differ")
    if not fin.any():
        return 0.0
    scale = float(np.abs(b[fin]).max())
    d = float(np.abs(a[fin] - b[fin]).max())
    return d / scale if scale > 0 else d


def phase_percall(dev, store, tmp, pf, zfile):
    """Phase 14: the float64 per-call family on phase 11's bgzf files, on
    the card and on the CPU: each analysis, and the engine's float64
    impute_window (device_linalg False), within PERCALL_RTOL."""
    t0 = time.perf_counter()
    n = min(STREAM_SNPS, len(store.index))
    first = int(store.index["bp"].iloc[0])
    lo, hi = first + WING_BP, first + WING_BP + WINDOW_BP - 1
    wgt_df = pd.DataFrame({"pop": store.desc.pops,
                           "wgt": 1.0 / store.desc.num_pops})
    annot = os.path.join(tmp, "percall_annot.txt")
    make_annotation(IndexOf(store.index.iloc[:n]), annot,
                    n_genes=PERCALL_GENES, snps_per_gene=GENE_SNPS)
    files = (zfile, pf.index_file, pf.data_file, pf.pop_desc_file)
    win = (22, lo, hi, WING_BP)
    calls = {
        "dist": lambda d: pkg.dist(*win, STUDY_POP, *files, device=d),
        "distmix": lambda d: pkg.distmix(*win, wgt_df, *files, device=d),
        "compute_ld": lambda d: pkg.compute_ld(22, lo, hi, wgt_df, *files,
                                               device=d),
        "qcat": lambda d: pkg.qcat(*win, STUDY_POP, *files, device=d),
        "qcatmix": lambda d: pkg.qcatmix(*win, wgt_df, *files, device=d),
        "prep_qcat": lambda d: pkg.prep_qcat(*win, STUDY_POP, *files,
                                             device=d),
        "prep_recessive_impute": lambda d: pkg.prep_recessive_impute(
            *win, wgt_df, *files, device=d),
        "jepeg": lambda d: pkg.jepeg(STUDY_POP, zfile, annot, *files[1:],
                                     device=d),
        "jepegmix": lambda d: pkg.jepegmix(wgt_df, zfile, annot,
                                           *files[1:], device=d),
        "prep_zmix": lambda d: pkg.prep_zmix(*files, interval=8, device=d),
        "prep_zmix5": lambda d: pkg.prep_zmix5(*files, percentile=0.9,
                                               interval=1, device=d),
        "zmix": lambda d: pkg.zmix(*files, percentile=0.9, interval=2,
                                   device=d),
    }
    decoded = PanelStore.from_bgzf(pf, chrom=22)
    inp = readers.read_input_z(zfile, chrom=22, start_bp=lo, end_bp=hi,
                               wing_size=WING_BP)
    pop_wgt = dict(zip(wgt_df["pop"], wgt_df["wgt"]))
    runs = {str(d): GenomeEngine(decoded, device=d).prepare_mix(
        inp, pop_wgt, af1_cutoff=0.01) for d in (dev, "cpu")}
    calls["impute_window (float64)"] = \
        lambda d: runs[str(d)].impute_window(lo, hi, WING_BP).table
    reset_counts()
    for name, fn in calls.items():
        walls = {}
        res = {}
        for d in (dev, "cpu"):
            t = time.perf_counter()
            res[str(d)] = fn(d)
            walls[str(d)] = time.perf_counter() - t
        rel = norm_rel(res[str(dev)], res["cpu"])
        log(f"per-call {name}: card {walls[str(dev)]:.3f}s, CPU "
            f"{walls['cpu']:.3f}s; card vs CPU normwise rel diff {rel:.3e} "
            f"(tol {PERCALL_RTOL:g})")
        if not rel <= PERCALL_RTOL:
            raise AssertionError(f"per-call {name} on the card disagrees "
                                 f"with the CPU")
    counts = read_counts()
    log(f"phase 14: {len(calls)} analyses on [{lo}, {hi}] (wings "
        f"{WING_BP}), launches {counts} (the per-call family runs plain "
        f"torch products; jepeg and jepegmix's gene correlations "
        f"gene_partials and gene_corr, once per bucket each); "
        f"{time.perf_counter() - t0:.1f}s")
    if counts["gene_partials"] < 2 or counts["gene_stats_tail"] or \
            counts["gene_partials"] != counts["gene_corr"]:
        raise AssertionError("per-call jepeg / jepegmix did not launch "
                             "gene_partials and gene_corr (the tail's "
                             "correlation mode) once per bucket")


def phase_probe_path():
    """The probe's own entry point (python -m
    gauss_tpu_torch.probes.probe7_int4), with the counts set to 0 just
    before it and read just after: K3 and K4 must run in it."""
    reset_counts()
    rc = p7.main()
    counts = read_counts()
    log(f"probe7 main() exit {rc}; launches during it: {counts}")
    if rc != 0:
        raise AssertionError("the probe's own checks failed")
    if counts["int4_dot"] < 1 or counts["resident_rowsum"] < 1:
        raise AssertionError("the probe did not launch K3 and K4")
    return counts


# K3's edge shapes, as in tests/test_torch_probe7.py's GPU tests: M, N and
# K off every tile and box edge, K not a multiple of the 256-value box (or
# below one box) and K a multiple of it, an odd number of 128-column tiles
# (a pair's second tile empty), 1 x 1 x 1, the bench width
K3_EDGES = [(130, 70, 300), (1, 1, 1), (300, 129, 2049), (64, 64, 32),
            (130, 129, 4352), (257, 300, 1000), (1000, 257, 34176)]
# int4's ends: -8 x -8 and 7 x -8 in every product
K3_EXTREMES = [(-8, -8), (7, -8)]


def sass_mma(kernel):
    """Counts of the tensor-core instructions in the SASS of one kernel of
    the built library (cuobjdump): mma.sync's IMMA/HMMA and wgmma's
    IGMMA/HGMMA."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    so = [f for f in glob.glob(os.path.join(_build.BUILD_DIR, "*.so"))
          if os.path.basename(f).startswith("libgauss_kernels_")]
    sass = subprocess.run([tool, "-sass", max(so, key=os.path.getmtime)],
                          check=True, capture_output=True, text=True,
                          timeout=300).stdout
    body = next(f for f in sass.split("Function : ") if kernel in
                f.split("\n", 1)[0])
    return dict(collections.Counter(re.findall(r"\b[IH]G?MMA[.\w]*", body)))


def k3_check(label, a, b, reps=5, plain_reps=2, parts=False):
    """K3 against its plain version (exact), timed beside its bound and
    torch._int_mm on the int8 operands.  With ``parts``, K3's product on
    the packed operands and its packing pass are also timed apart, each
    beside its own bound (the product: its operations, or the packed
    operands read once and C written once; the pack: the int8 operands
    read once and the packed ones written once)."""
    got = p7.int4_dot(a, b)
    equal = bool(torch.equal(got, p7.int4_dot_plain(a, b)))
    del got
    (M, K), N = a.shape, b.shape[0]
    ops = 2.0 * M * N * K
    ms = cuda_ms(lambda: p7.int4_dot(a, b), reps)
    pms = cuda_ms(lambda: p7.int4_dot_plain(a, b), plain_reps)
    lib = cuda_ms(lambda: torch._int_mm(a, b.t()), reps)
    b_ms, b_by = bound(ops, M * K + N * K + 4.0 * M * N)
    row = dict(max_abs_err=0.0, ms=ms, plain_ms=pms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib)
    msg = (f"K3 int4_dot {label}: M={M} N={N} K={K}: exact={equal}; "
           f"pack + product {ms:.3f} ms per call ({ops / ms / 1e9:.1f} "
           f"TOP/s), bound {b_ms:.3f} ms ({b_by}, int8 peak) = "
           f"{b_ms / ms:.1%} of bound, torch._int_mm {lib:.3f} ms, plain "
           f"{pms:.3f} ms")
    if parts:
        width = p7.k3_width(K)
        pa, pb = p7._pack(a, width), p7._pack(b, width)
        prod = cuda_ms(lambda: p7._int4_dot_packed(pa, pb), reps)
        pack = cuda_ms(lambda: (p7._pack(a, width), p7._pack(b, width)),
                       reps)
        pr_ms, pr_by = bound(ops, (M + N) * width + 4.0 * M * N)
        pk_ms, pk_by = bound(0.0, (M + N) * (K + width))
        row.update(product_ms=prod, product_bound_ms=pr_ms,
                   product_bound_by=pr_by, pack_ms=pack,
                   pack_bound_ms=pk_ms, pack_bound_by=pk_by)
        msg += (f"; product on packed operands ({width} B rows) {prod:.3f} "
                f"ms ({ops / prod / 1e9:.1f} TOP/s), bound {pr_ms:.3f} ms "
                f"({pr_by}) = {pr_ms / prod:.1%}; packing pass {pack:.3f} "
                f"ms, bound {pk_ms:.3f} ms ({pk_by}) = {pk_ms / pack:.1%}")
        del pa, pb
    if min(ms, lib) < SHORT_MS:
        row.update(device_times(lambda: p7.int4_dot(a, b),
                                lambda: torch._int_mm(a, b.t())))
    log(msg + fmt_device(row))
    if not equal:
        raise AssertionError(f"K3 {label} differs from its plain version")
    torch.cuda.empty_cache()
    return row


def k3_edges(dev):
    """K3 exactly against its plain version at the edge shapes and at
    int4's ends."""
    rng = np.random.default_rng(1)
    for M, N, K in K3_EDGES:
        a = torch.from_numpy(rng.integers(-8, 8, (M, K), dtype=np.int8))
        b = torch.from_numpy(rng.integers(-8, 8, (N, K), dtype=np.int8))
        a, b = a.to(dev), b.to(dev)
        if not torch.equal(p7.int4_dot(a, b), p7.int4_dot_plain(a, b)):
            raise AssertionError(f"K3 differs from its plain version at "
                                 f"M={M} N={N} K={K}")
    for va, vb in K3_EXTREMES:
        a = torch.full((130, 4099), va, dtype=torch.int8, device=dev)
        b = torch.full((200, 4099), vb, dtype=torch.int8, device=dev)
        if not bool((p7.int4_dot(a, b) == va * vb * 4099).all()):
            raise AssertionError(f"K3 wrong at {va} x {vb}")
    log(f"K3 exact at the edge shapes (M, N, K) {K3_EDGES} and at "
        f"{K3_EXTREMES} over 130 x 200 x 4099")


def k4_check(dtype, cluster, x8, reps=5):
    """K4 at every size that fits one cluster, exactly, then timed at the
    largest beside its bound and x.sum(1) on the int8 block: per call
    (CUDA events, host included) and on the device alone."""
    blk = x8 if dtype == "int8" else p7.pack_int4(x8)
    row_bytes = blk.shape[1]
    k, optin, n = p7.capacity(row_bytes, cluster)
    R = k * cluster
    if R < 1 or R > blk.shape[0]:
        raise AssertionError(f"K4 {dtype} cluster {cluster}: {R} rows fit")
    bad = [r for r in range(1, R + 1)
           if not torch.equal(p7.resident_rowsum(blk[:r], dtype, cluster),
                              p7.resident_rowsum_plain(blk[:r], dtype))]
    x, xb = blk[:R].contiguous(), x8[:R].contiguous()
    ms = cuda_ms(lambda: p7.resident_rowsum(x, dtype, cluster), reps)
    pms = cuda_ms(lambda: p7.resident_rowsum_plain(x, dtype), reps)
    lib = cuda_ms(lambda: xb.sum(1, dtype=torch.int32), reps)
    dev = device_times(lambda: p7.resident_rowsum(x, dtype, cluster),
                       lambda: xb.sum(1, dtype=torch.int32))
    b_ms, b_by = bound(0.0, R * row_bytes + R * 128 * 4.0)
    log(f"K4 resident_rowsum {dtype} cluster {cluster}: {k} rows/CTA = "
        f"{k * row_bytes / 1024:.1f} KiB of {optin / 1024:.1f} KiB, {R} "
        f"rows = {R * row_bytes / 1024:.1f} KiB per cluster, {n} clusters "
        f"at once; sizes 1..{R} exact={not bad}; at {R} rows kernel "
        f"{ms:.4f} ms per call, bound {b_ms:.4f} ms ({b_by}) = "
        f"{b_ms / ms:.1%} of bound, x.sum(1) {lib:.4f} ms, plain "
        f"{pms:.4f} ms{fmt_device(dev)}; device-only share of bound "
        + (f"{b_ms / dev['device_ms']:.1%}" if dev else "not measured"))
    if bad:
        raise AssertionError(f"K4 {dtype} cluster {cluster} wrong at "
                             f"{bad[:5]} rows")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=pms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib, rows=R, rows_per_cta=k,
                clusters_at_once=n, **dev)


def phase_probe7(dev):
    """Probe 7's kernels against their plain versions: K3 at the TPU
    probe's shape, at K1's yardstick shape and at the edge shapes, K4 at
    every size that fits (int8 and int4, clusters of 1 and 8).  These
    launches check and time the kernels: no path of the system runs them,
    so none is counted."""
    ops = sass_mma("int4_dot_kernel")
    log(f"K3 SASS tensor-core instructions: {ops}")
    if not any(op.startswith("IGMMA") for op in ops) or \
            any(op.startswith("IMMA") for op in ops):
        raise AssertionError("K3 did not compile to integer wgmma alone")
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-2, 3, (256, 2048),
                                      dtype=np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-2, 3, (256, 2048),
                                      dtype=np.int8)).to(dev)
    k3 = {"probe 256x2048": k3_check("probe shape 256 x 2048", a, b)}
    k3_edges(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    A = torch.randint(-2, 3, (43 * 1280, 34176), dtype=torch.int8,
                      device=dev, generator=g)
    B = torch.randint(-2, 3, (1280, 34176), dtype=torch.int8, device=dev,
                      generator=g)
    k3["K1 yardstick 55040x1280x34176"] = k3_check(
        "K1 yardstick shape", A, B, parts=True)
    del A, B
    torch.cuda.empty_cache()
    x8 = torch.from_numpy(rng.integers(0, 3, (160, p7.ROW),
                                       dtype=np.int8)).to(dev)
    k4 = {f"{dt} cluster {c}": k4_check(dt, c, x8)
          for dt in ("int8", "int4") for c in (1, 8)}
    for dt, rb in (("int8", p7.ROW), ("int4", p7.ROW // 2)):
        k, optin, n = p7.capacity(rb, 16)
        log(f"K4 capacity {dt} cluster 16 (non-portable): {k} rows/CTA, "
            f"{16 * k} rows = {16 * k * rb / 1024:.1f} KiB per cluster, "
            f"{n} clusters at once")
    return k3, k4, ops


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--snps", type=int, default=MAIN_SNPS,
                    help="region length in SNPs (default: the bench "
                         "workload, 64,000)")
    args = ap.parse_args()

    dev, name = phase_device()
    phase_build()
    # as a caller with TF32 on: the engine must leave the switch alone and
    # still run its tails in full f32
    torch.backends.cuda.matmul.allow_tf32 = True
    engine, run, res, lo, hi, launches, batch, region_ms = phase_main(
        dev, args.snps)
    kernels = phase_kernels(engine, run, batch, region_ms)
    del batch
    max_dz, first_host = phase_parity(run, res, lo)
    ld_launches, _, ld_checks, ld_ref = phase_ld(run, lo, hi)
    qcat_launches, _, qcat_checks, qcat_ref = phase_qcat(engine, run, lo,
                                                        hi)
    del run
    torch.cuda.empty_cache()
    jepeg_launches, jepeg, annot = phase_jepeg(engine)
    gene_ref = jepeg["jepegmix"].pop("frame")
    jepeg["jepeg"].pop("frame")
    with tempfile.TemporaryDirectory(prefix="gauss_smoke_") as tmp:
        runner_launches, prep, later, runner_ref = phase_runner(
            engine, res, lo, hi, tmp)
        # phase 12's single windows run here, on phase 10's prepared
        # state, which is then released: the peaks below are each run's own
        window_launches, window_dz, later["impute_window"], window_ref = \
            phase_window(prep, res, lo, hi, first_host)
        phase_trace(prep, lo)
        del prep
        torch.cuda.empty_cache()
        counts, checks = phase_runner_analyses(
            engine, lo, hi, tmp, ld_ref, qcat_ref, gene_ref, annot)
        runner_launches.update(counts)
        later.update(checks)
        stream_launches, later["streaming"], *stream = phase_stream(
            engine.store, dev, tmp)
        cli_launches, checks = phase_cli(dev, tmp, *stream)
        later.update(checks)
        # phase 13 on the bench store; phase 3's engine and its panel go
        # first
        store = engine.store
        del engine
        torch.cuda.empty_cache()
        mesh_launches, later["mesh"], _ = phase_mesh(
            dev, store, res, lo, hi, region_ms,
            dict(qcat=qcat_ref, ld=ld_ref, genes=gene_ref, annot=annot,
                 window=window_ref, runner=runner_ref,
                 first_host=first_host), tmp, stream)
        phase_percall(dev, store, tmp, *stream[:2])
        del stream, ld_ref, qcat_ref, gene_ref, window_ref, runner_ref
    torch.cuda.empty_cache()
    log(f"tf32 matmul={torch.backends.cuda.matmul.allow_tf32} after every "
        f"path (set True before phase 3); phase 5 max|dZ| {max_dz:.3e}, "
        f"device impute_window max|dZ| {window_dz:.3e}")
    if not torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("a path switched the caller's TF32 off")
    probe_launches = phase_probe_path()
    k3, k4, k3_sass = phase_probe7(dev)

    routes = {
        "weighted_gram_t1": ("gauss_tpu_torch/csrc/gram.cu",
                             "gauss_tpu/ops/pallas_gram.py:203"),
        "gather_rows": ("gauss_tpu_torch/csrc/gather.cu",
                        "gauss_tpu/ops/dma_gather.py:70"),
        "int4_dot": ("gauss_tpu_torch/csrc/probe7_int4.cu",
                     "probes/probe7_int4.py:49"),
        "resident_rowsum": ("gauss_tpu_torch/csrc/probe7_int4.cu",
                            "probes/probe7_int4.py:71"),
        **TAIL_KERNELS,
        **GENE_KERNELS,
    }
    # ms / plain_ms / bound_ms / library_ms of each row: the impute batch
    # (K1, K2), K1's yardstick shape (K3), int8 in clusters of 8 (K4), one
    # jepegmix jepeg_region's buckets (the gene kernels); the other checks
    # beside, by path
    checked = {
        "weighted_gram_t1": {"impute": kernels["weighted_gram_t1"],
                             "ld": ld_checks["weighted_gram_t1"],
                             "qcat": qcat_checks["weighted_gram_t1"]},
        "gather_rows": {"impute": kernels["gather_rows"],
                        "ld": ld_checks["gather_rows"],
                        **{f"jepeg {m}": r["k2"]
                           for m, r in jepeg.items()}},
        "int4_dot": {"probe7": k3},
        "resident_rowsum": {"probe7": k4},
        "corr_mm": {"impute": kernels["corr_mm"], "qcat":
                    qcat_checks["corr_mm"], "ld": ld_checks["corr_mm"]},
        "corr_um_rhs": {"impute": kernels["corr_um_rhs"],
                        "qcat": qcat_checks["corr_um_rhs"]},
        "cholesky_solve": {"impute": kernels["cholesky_solve"],
                           "qcat": qcat_checks["cholesky_solve"]},
        "impute_finalize": {"impute": kernels["impute_finalize"]},
        **{k: {f"jepeg {m}": r[k] for m, r in jepeg.items()}
           for k in GENE_KERNELS},
    }
    # the later paths' own batches (runner chunks, one window, a streamed
    # chunk, the command line's regions)
    for path, c in later.items():
        for kname, check in c.items():
            checked[kname][path] = check
    top = {"weighted_gram_t1": kernels["weighted_gram_t1"],
           "gather_rows": kernels["gather_rows"],
           "int4_dot": k3["K1 yardstick 55040x1280x34176"],
           "resident_rowsum": k4["int8 cluster 8"],
           **{k: kernels[k] for k in TAIL_KERNELS},
           **{k: jepeg["jepegmix"][k] for k in GENE_KERNELS}}
    by_path = {"impute": launches, "ld": ld_launches, "qcat": qcat_launches,
               "jepeg": jepeg_launches, **runner_launches,
               "impute_window": window_launches, "streaming": stream_launches,
               **cli_launches, **mesh_launches, "probe7": probe_launches}
    # the path each row's "launches" counts: the main path for K1, K2 and
    # the region tail's kernels, the probe for K3 and K4, phase 8's jepeg
    # path (jepegmix and jepeg, two calls each) for the gene kernels
    own = {"weighted_gram_t1": launches, "gather_rows": launches,
           "int4_dot": probe_launches, "resident_rowsum": probe_launches,
           **dict.fromkeys(TAIL_KERNELS, launches),
           **dict.fromkeys(GENE_KERNELS, jepeg_launches)}
    extra = ("product_ms", "product_bound_ms", "pack_ms", "pack_bound_ms",
             "device_ms", "library_device_ms")
    rows = []
    for kname, (src, replaces) in routes.items():
        if not os.path.exists(os.path.join(HERE, src)):
            raise AssertionError(f"missing kernel source {src}")
        flat = [c for v in checked[kname].values()
                for c in (v.values() if "ms" not in v else [v])]
        row = {"name": kname, "route": "cuda", "source": src,
               "replaces": replaces, "launches": own[kname].get(kname, 0),
               "launches_by_path": {p: c.get(kname, 0)
                                    for p, c in by_path.items()},
               **{k: top[kname][k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms")},
               **{k: top[kname][k] for k in extra if k in top[kname]},
               "max_abs_err": max(c["max_abs_err"] for c in flat),
               "checked_by_path": checked[kname]}
        if kname == "int4_dot":
            row["sass_mma"] = k3_sass
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

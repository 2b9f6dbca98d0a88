#!/usr/bin/env python
"""Drive gauss_tpu_torch's region paths once on one CUDA card and check
them.

    python3 chip_smoke.py [--snps N]

Phases (each prints its evidence; any failure exits non-zero):

1. device  -- needs torch.cuda; prints the card and its power limit.
2. build   -- compiles the CUDA kernels (K1 gram, K2 gather) from
              gauss_tpu_torch/csrc with nvcc for sm_90a; prints ptxas's
              registers, spills and shared memory per kernel and K1's
              dynamic shared memory.
3. main    -- the bench workload: a 33KG-shaped panel (29 populations,
              33,153 subjects) of --snps SNPs at 1,500 SNPs/Mb, 40%
              measured, 1 Mb windows with 500 kb wings, imputed by
              GenomeEngine.prepare_mix -> impute_region (twice, blocking)
              -> impute_regions (8 passes, 2 in flight).  The kernels'
              launch counts must rise during it.
4. kernels -- each kernel against its plain PyTorch version on the card,
              on the main path's own region batch (K1 rel err <= 1e-6,
              K2 bit-equal), timed with CUDA events beside its bound (the
              larger of its operations over the int8 peak and its bytes
              over the HBM rate) and one PyTorch call doing the same
              work (torch._int_mm for K1, torch.index_select for K2).
5. parity  -- the first window against the port's float64 host path:
              max|dZ| <= 1e-4 on imputed rows, measured rows bit-equal.
6. LD      -- PreparedRun.ld_region over the same region (1 Mb windows,
              computeLD semantics), fetch "i16tri" and "f32" on the same
              prepared run: K1 runs at least once per call and K2 gathers
              the measured panel; K1 and K2 against their plain versions
              on the LD batch's own inputs (band offsets at each window's
              first measured row); the first, middle and last windows
              against the float64 ldkernels.weighted_corr (max|dr| <=
              2e-4, plus LD_I16_MAX_ERR for i16tri; unit diagonal exact);
              K1 there with its bound and yardstick as in phase 4.
7. qcat    -- PreparedRun.qcat_region over the same region with impute's
              windows (its region batch rebuilt, so K2 runs too): K1 twice
              per slab of windows, checked against its plain version at
              both shapes with its bound and yardstick; the first, middle
              and last windows
              against the float64 host qcat (_qcat_core on
              _build_corr_blocks_fn's blocks): qcat_m equal, max|dr| <=
              1e-4 on r = t / sqrt(m - 3).
8. jepeg   -- GenomeEngine.prepare_genes -> PreparedGenes.jepeg_region
              on the same store: 280 genes x 24 annotated SNPs
              (utils/testing.make_annotation), jepegmix (the main path's
              weights) and jepeg (one population), jepeg_region twice
              each; K2 launches at least once per gene bucket and is
              checked against its plain version on the path's own ids
              (bit-equal, with its bound and yardstick); every gene
              against the same call on a CPU engine (chisq and p-values
              rtol 1e-9; df, geneid, top_categ, top_snp equal).
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

Calls shorter than SHORT_MS (K2 on the gene buckets, K3 at the probe
shape, K4, and their yardsticks) are timed twice: per call with CUDA
events, host included (cuda_ms), and on the device alone from
torch.profiler's kernel records (device_ms), which names the kernels.

Each path's kernel launch counts are set to 0 just before it runs and
read just after.  The line before the last is a JSON object
{"kernels": [...]}; the last is {"ok": true, "device": {...}}.
"""

import argparse
import collections
import dataclasses
import glob
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gauss_tpu_torch.core import genekernels, ldkernels        # noqa: E402
from gauss_tpu_torch.io import readers                         # noqa: E402
from gauss_tpu_torch.models import qcat                        # noqa: E402
from gauss_tpu_torch.models.genome import (GenomeEngine,       # noqa: E402
                                           _build_corr_blocks_fn)
from gauss_tpu_torch.ops import _build, gather, gram           # noqa: E402
from gauss_tpu_torch.probes import probe7_int4 as p7           # noqa: E402
from gauss_tpu_torch.utils.testing import make_annotation      # noqa: E402
from gauss_tpu_torch.ops.gram import ROW_TILE                  # noqa: E402
from gauss_tpu_torch.ops.window_kernel import (LD_I16_MAX_ERR,  # noqa: E402
                                               _gram_segments, win_slab)
from gauss_tpu_torch.utils.benchdata import (cached_panel,     # noqa: E402
                                             make_bench_input)

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".bench_cache")   # generated panels (gitignored)
MEASURED_FRAC = 0.4
WINDOW_BP = 1_000_000
WING_BP = 500_000
N_PIPE = 8
K1_REL_TOL = 1e-6        # f32 folds of exact int32 segment sums
DZ_TOL = 1e-4            # f32 region solves vs the float64 host path
DR_LD_TOL = 2e-4         # f32 LD vs the float64 weighted correlations
DR_QCAT_TOL = 1e-4       # f32 qcat correlations vs the float64 host qcat
GENE_RTOL = 1e-9         # float64 gene statistics, card vs CPU
N_GENES, GENE_SNPS = 280, 24   # ~6.5 genes per Mb over the 43 Mb region
STUDY_POP = "CEU"        # jepeg's one population (the largest)
WARM_S = 0.05            # warm-up seconds before each timing
SHORT_MS = 0.2           # calls shorter than this are also timed on the
                         # device alone (device_ms)
# published peaks of one H100 SXM (dense int8 tensor-core rate, HBM3 rate)
INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def reset_counts():
    gram.launches = 0
    gather.launches = 0
    for k in p7.launches:
        p7.launches[k] = 0


def read_counts():
    return {"weighted_gram_t1": gram.launches,
            "gather_rows": gather.launches, **p7.launches}


def cuda_ms(fn, reps):
    """Median milliseconds of fn() on the card: one CUDA event pair per
    call, the calls enqueued back to back and one synchronize at the end,
    so that a call's host-side work overlaps the device work of the call
    before it.  Warm-up calls run first for at least WARM_S seconds: a
    kernel's first calls after other work can run slower than its
    steady state."""
    t = time.perf_counter()
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t >= WARM_S:
            break
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in events:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def device_ms(fn, reps=50):
    """(milliseconds per call on the device alone, {kernel short_name: ms
    per call}): the CUDA kernels torch.profiler records over ``reps`` calls
    enqueued back to back after a warm-up call, their host path left out.
    Raises if the profiler records no device time."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            if us > 0:
                kernels[short_name(e.key)] = us / 1e3 / reps
    if not kernels:
        raise RuntimeError("torch.profiler recorded no device time")
    return sum(kernels.values()), kernels


def short_name(kernel):
    """A kernel's name without "void", an anonymous namespace or its
    argument list, cut to 80 characters."""
    k = kernel.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for i, ch in enumerate(k):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            k = k[:i]
            break
    return k[:80]


def device_times(fn, lib_fn):
    """device_ms of a kernel's wrapper and of its yardstick, as row keys."""
    d, dk = device_ms(fn)
    ld, lk = device_ms(lib_fn)
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
        f"{torch.backends.cudnn.allow_tf32} (the engine sets both False)")
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
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("the engine left TF32 on")

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


def k1_check(label, args, reps=5, plain_reps=2):
    """K1 against its plain version on one launch's arguments (a sym
    launch's lower triangles mirrored on both sides), then timed beside
    its plain version, its bound and its torch._int_mm yardstick.  Fails
    above K1_REL_TOL."""
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
    b_ms, b_by = k1_bound(Wp, nx, ny, sum(sizes), sym)
    lib = k1_library_ms(A, B, a0, b0, nx, ny, reps)
    log(f"K1 {label}: W={Wp} nx={nx} ny={ny} S={S} ({sum(sizes)} real) "
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


def k2_check(label, G, rows, reps=5):
    """K2 against its plain version on one gather's row ids (-1 =
    sentinel), then timed beside its plain version, its bound (each
    distinct panel row read once, every output row written once) and
    torch.index_select on the clamped ids (the same bytes; sentinel rows
    not zeroed).  Fails unless bit-equal."""
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
           if min(ms, lib) < SHORT_MS else {})
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
    log(f"region {region_ms:.3f} ms = K1 {k1['ms']:.3f} ms (mm + um) + "
        f"tail {region_ms - k1['ms']:.3f} ms")

    # K2 on the batch's own index vectors: both bands' row ids, -1
    # sentinels padding each window's band
    k2 = k2_check("impute batch", run._device_panel(),
                  np.concatenate(run._aligned_rows(batch.plans)))
    return {"weighted_gram_t1": k1, "gather_rows": k2}


def phase_parity(run, res, lo):
    t = time.perf_counter()
    a = run.impute_window(lo, lo + WINDOW_BP - 1, WING_BP).table
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
    return max_dz


def k1_ms(run, Xa, Xb, a0, b0, na, nb, sym, reps=5):
    """K1 alone at a path's own shapes, CUDA events."""
    seg = segments(run)
    return cuda_ms(lambda: gram.weighted_gram_t1(Xa, Xb, *seg, a0, b0, na,
                                                 nb, sym), reps)


def host_wall(fn, reps=3):
    """Median host seconds of fn(), each call ending in a synchronize."""
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return statistics.median(walls)


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
        log(f"LD {fetch}: W={W} (Wp={args[3].shape[0]}), Mp={Mp}: region "
            f"on the card {dev_ms:.3f} ms (CUDA events, median of {reps}) "
            f"= K1 {kms:.3f} ms + tail {dev_ms - kms:.3f} ms; ld_region "
            f"{wall * 1e3:.1f} ms wall (median of 3) -> {W / wall:.1f} "
            f"windows/s; {n_bytes} bytes copied to the host")
        out[fetch] = dict(ms=dev_ms, k1_ms=kms, wall_s=wall, bytes=n_bytes)

    # K1 and K2 against their plain versions on the LD batch's own inputs:
    # the measured half, its band offsets (each window's first measured
    # row, mostly not ROW_TILE multiples) and the half's gathered row ids
    Xm, _, _, m_t0, _ = args
    checks = {"weighted_gram_t1": k1_check(
        "LD mm", (Xm, Xm, *segments(run), m_t0, m_t0, Mp, Mp, True))}
    cap = run._res[("half", 1)][0]
    checks["gather_rows"] = k2_check("LD measured half", run._device_panel(),
                                     run._half_rows(1, cap))

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
    return launches, out, checks


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

    fn = run._kernel_fn("qcat", b.Mp, b.Up)
    dev_ms = cuda_ms(lambda: fn(*b.arrays, *b.inputs), reps)
    Xm, Xu = b.arrays[0], b.arrays[1]
    m0, u0 = b.inputs[0], b.inputs[1]
    seg = segments(run)
    k1 = sum_checks([
        k1_check("qcat mm", (Xm, Xm, *seg, m0, m0, b.Mp, b.Mp, True), reps),
        k1_check("qcat um", (Xu, Xm, *seg, u0, m0, b.Up, b.Mp, False),
                 reps)])
    kms = k1["ms"]
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
                          max_dr=max_dr), k1

class _IndexOf:
    """What make_annotation reads of a panel: its index."""

    def __init__(self, index):
        self.index_df = index


def gene_frames_agree(got, ref):
    """(max relative difference of chisq and the p-values, whether df,
    geneid, top_categ and top_snp are equal) of two jepeg frames."""
    got = got.sort_values("geneid", kind="stable").reset_index(drop=True)
    ref = ref.sort_values("geneid", kind="stable").reset_index(drop=True)
    same = len(got) == len(ref) and all(
        list(got[c]) == list(ref[c])
        for c in ("df", "geneid", "top_categ", "top_snp"))
    rel = 0.0
    for c in ("chisq", "jepeg_pval", "top_categ_pval", "top_snp_pval"):
        a, b = got[c].to_numpy(), ref[c].to_numpy()
        if not np.allclose(a, b, rtol=GENE_RTOL, atol=1e-300,
                           equal_nan=True):
            rel = float("inf")
        d = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
        rel = max(rel, float(np.nanmax(d)) if len(d) else 0.0)
    return rel, same


def phase_jepeg(engine, reps=3):
    """prepare_genes -> jepeg_region on the main path's store and input:
    jepegmix with the main path's weights, then jepeg on one population,
    jepeg_region twice each; every gene against a CPU engine's run."""
    store = engine.store
    inp = make_bench_input(store, MEASURED_FRAC)
    path = os.path.join(CACHE, f"annot_{len(store.index)}.txt")
    os.makedirs(CACHE, exist_ok=True)
    make_annotation(_IndexOf(store.index), path,
                    n_genes=min(N_GENES, len(store.index) // (GENE_SNPS + 1)),
                    snps_per_gene=GENE_SNPS)
    annot = readers.read_annotation(path)
    cpu = GenomeEngine(store, device="cpu")
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}
    total = {"gather_rows": 0}
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
        log(f"jepeg ({mode}): {len(gsel)} genes ({len(pg.zs)} gene SNPs), "
            f"{len(buckets)} buckets (sizes "
            f"{[(npad, len(b)) for npad, b in buckets]}), panel "
            f"{tuple(panel.shape)} on the card; launches during "
            f"jepeg_region x2: {launches}")
        if launches["gather_rows"] < 2 * len(buckets):
            raise AssertionError("K2 was not launched once per gene bucket")
        total["gather_rows"] += launches["gather_rows"]

        stats = lambda: genekernels.gene_stats_resident(
            panel, idx, Ws, zs, pg.pop_sizes, pg.wgts,
            lam=engine.settings.lambda_)
        dev_ms = cuda_ms(stats, reps)
        wall = host_wall(pg.jepeg_region, reps)
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
        if not (rel <= GENE_RTOL and same and tested > 0):
            raise AssertionError(f"jepeg ({mode}) on the card disagrees "
                                 f"with the CPU engine")
        ids = genekernels._bucket_rows(buckets, idx)
        out[mode] = dict(ms=dev_ms, wall_s=wall, genes=len(gsel),
                         buckets=len(buckets), max_rel=rel,
                         k2=k2_check(f"jepeg {mode} buckets", panel, ids))
    return total, out


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
        f"{b_ms / dev['device_ms']:.1%}")
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
    ap.add_argument("--snps", type=int, default=64_000,
                    help="region length in SNPs (default: the bench "
                         "workload, 64,000)")
    args = ap.parse_args()

    dev, name = phase_device()
    phase_build()
    engine, run, res, lo, hi, launches, batch, region_ms = phase_main(
        dev, args.snps)
    kernels = phase_kernels(engine, run, batch, region_ms)
    del batch
    phase_parity(run, res, lo)
    ld_launches, _, ld_checks = phase_ld(run, lo, hi)
    qcat_launches, _, qcat_k1 = phase_qcat(engine, run, lo, hi)
    del run
    torch.cuda.empty_cache()
    jepeg_launches, jepeg = phase_jepeg(engine)
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
    }
    # ms / plain_ms / bound_ms / library_ms of each row: the impute batch
    # (K1, K2), K1's yardstick shape (K3), int8 in clusters of 8 (K4); the
    # other checks beside, by path
    checked = {
        "weighted_gram_t1": {"impute": kernels["weighted_gram_t1"],
                             "ld": ld_checks["weighted_gram_t1"],
                             "qcat": qcat_k1},
        "gather_rows": {"impute": kernels["gather_rows"],
                        "ld": ld_checks["gather_rows"],
                        **{f"jepeg {m}": r["k2"]
                           for m, r in jepeg.items()}},
        "int4_dot": {"probe7": k3},
        "resident_rowsum": {"probe7": k4},
    }
    top = {"weighted_gram_t1": kernels["weighted_gram_t1"],
           "gather_rows": kernels["gather_rows"],
           "int4_dot": k3["K1 yardstick 55040x1280x34176"],
           "resident_rowsum": k4["int8 cluster 8"]}
    by_path = {"impute": launches, "ld": ld_launches, "qcat": qcat_launches,
               "jepeg": jepeg_launches, "probe7": probe_launches}
    # the path each row's "launches" counts: the main path for K1 and K2,
    # the probe for K3 and K4
    own = {"weighted_gram_t1": launches, "gather_rows": launches,
           "int4_dot": probe_launches, "resident_rowsum": probe_launches}
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

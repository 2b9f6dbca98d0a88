#!/usr/bin/env python
"""Drive gauss_tpu_torch's main path once on one CUDA card and check it.

    python3 chip_smoke.py [--snps N]

Phases (each prints its evidence; any failure exits non-zero):

1. device  -- needs torch.cuda; prints the card and its power limit.
2. build   -- compiles the CUDA kernels (K1 gram, K2 gather) from
              gauss_tpu_torch/csrc with nvcc for sm_90a.
3. main    -- the bench workload: a 33KG-shaped panel (29 populations,
              33,153 subjects) of --snps SNPs at 1,500 SNPs/Mb, 40%
              measured, 1 Mb windows with 500 kb wings, imputed by
              GenomeEngine.prepare_mix -> impute_region (twice, blocking)
              -> impute_regions (8 passes, 2 in flight).  The kernels'
              launch counts must rise during it.
4. kernels -- each kernel against its plain PyTorch version on the card,
              on the main path's own region batch (K1 rel err <= 1e-6,
              K2 bit-equal), timed with CUDA events.
5. parity  -- the first window against the port's float64 host path:
              max|dZ| <= 1e-4 on imputed rows, measured rows bit-equal.

The line before the last is a JSON object {"kernels": [...]}; the last
is {"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from gauss_tpu_torch.models.genome import GenomeEngine          # noqa: E402
from gauss_tpu_torch.ops import _build, gather, gram           # noqa: E402
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


def log(msg):
    print(f"[smoke] {msg}", flush=True)


def cuda_ms(fn, reps):
    """Median milliseconds of fn() on the card, one CUDA event pair per
    call after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


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
        if "registers" in line or "Compiling entry" in line:
            log(f"  ptxas: {line.strip()}")


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

    gram.launches = 0
    gather.launches = 0
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
    launches = {"weighted_gram_t1": gram.launches,
                "gather_rows": gather.launches}
    n_regions = 2 + N_PIPE
    log(f"launches during the main path: {launches} over {n_regions} "
        f"region calls and 1 prepared batch")
    if launches["weighted_gram_t1"] < 2 * n_regions:
        raise AssertionError("K1 was not launched twice per region")
    if launches["gather_rows"] < 2:
        raise AssertionError("K2 was not launched for the prepared batch")

    batch = run._region_batch(lo, hi, WINDOW_BP, WING_BP)
    plans, inputs, arrays, fn = batch
    Wp, Mp = inputs[2].shape
    Up = inputs[4].shape[1]
    S = arrays[0].shape[1]
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"region: {len(plans)} windows (Wp={Wp}, Mp={Mp}, Up={Up}, S={S}), "
        f"{n_imputed} imputed SNPs per pass; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"first pass (incl. panel upload, K2 gathers, preparation) "
        f"{first_s:.3f}s; blocking pass {block_s:.4f}s -> "
        f"{n_imputed / block_s:.1f} SNPs/s; pipelined ({N_PIPE} passes, "
        f"2 in flight) {pipe_s:.4f}s/pass -> {n_imputed / pipe_s:.1f} SNPs/s")
    region_ms = cuda_ms(lambda: fn(*arrays, *inputs), 5)
    log(f"region on the card (CUDA events, median of 5): {region_ms:.3f} ms")
    return engine, run, res, lo, launches, batch, region_ms


def phase_kernels(engine, run, batch, region_ms, reps=5):
    """K1 and K2 against their plain versions on the main path's own
    region batch: its shifted panels, band offsets and gathered row ids
    (the aligned layout, which the engine picks on this card)."""
    plans, inputs, arrays, _ = batch
    Xm, Xu = arrays[0], arrays[1]
    m0, u0 = inputs[0], inputs[1]
    Wp, Mp = inputs[2].shape
    Up = inputs[4].shape[1]
    if Xm.shape[0] != Wp * Mp or Xu.shape[0] != Wp * Up:
        raise AssertionError("the main path did not take the aligned "
                             "layout; K2's row ids below would not be its")
    spec = engine._spec(run.pop_sizes, run.wgts)
    seg = (spec.pop_sizes, spec.pop_sizes_padded, spec.wgts)
    n = sum(spec.pop_sizes)
    pooled = ((n,), (sum(spec.pop_sizes_padded),),
              ((n - 1.0) / (float(n) * n),))       # beta = 1
    cases = [
        ("mm", (Xm, Xm, *seg, m0, m0, Mp, Mp, True)),
        ("um", (Xu, Xm, *seg, u0, m0, Up, Mp, False)),
        ("mm pooled", (Xm, Xm, *pooled, m0, m0, Mp, Mp, True)),
    ]
    k1 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0)
    for label, args in cases:
        sym = args[-1]
        got = gram.weighted_gram_t1(*args)
        ref = gram.weighted_gram_t1_plain(*args)
        if sym:
            got, ref = gram.mirror_lower(got), gram.mirror_lower(ref)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        del got, ref
        ms = cuda_ms(lambda: gram.weighted_gram_t1(*args), reps)
        pms = cuda_ms(lambda: gram.weighted_gram_t1_plain(*args), 2)
        ops = 2.0 * Wp * args[7] * args[8] * sum(args[3])
        log(f"K1 {label}: W={Wp} nx={args[7]} ny={args[8]} S={sum(args[3])} "
            f"segments={len(args[3])}: max abs err {err:.3e}, rel "
            f"{rel:.3e} (tol {K1_REL_TOL:g}); kernel {ms:.3f} ms "
            f"({ops / ms / 1e9:.1f} int TOPS counting the full tile grid), "
            f"plain {pms:.3f} ms")
        if not rel <= K1_REL_TOL:
            raise AssertionError(f"K1 {label} disagrees with its plain "
                                 f"version: rel {rel:.3e}")
        if label != "mm pooled":
            k1["max_abs_err"] = max(k1["max_abs_err"], err)
            k1["ms"] += ms
            k1["plain_ms"] += pms
    log(f"region {region_ms:.3f} ms = K1 {k1['ms']:.3f} ms (mm + um) + "
        f"tail {region_ms - k1['ms']:.3f} ms")
    torch.cuda.empty_cache()

    # K2 on the batch's own index vectors: both bands' row ids, -1
    # sentinels padding each window's band
    rows_m, rows_u = run._aligned_rows(plans)
    idx = torch.from_numpy(np.concatenate([rows_m, rows_u])).to(Xm.device)
    G = run._device_panel()
    got = gather.gather_rows(G, idx)
    ref = gather.gather_rows_plain(G, idx)
    equal = bool(torch.equal(got, ref))
    del got, ref
    ms = cuda_ms(lambda: gather.gather_rows(G, idx), reps)
    pms = cuda_ms(lambda: gather.gather_rows_plain(G, idx), reps)
    N, S = idx.shape[0], G.shape[1]
    log(f"K2: R={G.shape[0]} S={S} N={N} ({int((idx < 0).sum())} "
        f"sentinels): bit-equal={equal}; kernel {ms:.3f} ms "
        f"({2.0 * N * S / ms / 1e6:.0f} GB/s read+write), plain "
        f"{pms:.3f} ms")
    if not equal:
        raise AssertionError("K2 differs from its plain version")
    torch.cuda.empty_cache()
    return {"weighted_gram_t1": k1,
            "gather_rows": dict(max_abs_err=0.0, ms=ms, plain_ms=pms)}


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--snps", type=int, default=64_000,
                    help="region length in SNPs (default: the bench "
                         "workload, 64,000)")
    args = ap.parse_args()

    dev, name = phase_device()
    phase_build()
    engine, run, res, lo, launches, batch, region_ms = phase_main(
        dev, args.snps)
    kernels = phase_kernels(engine, run, batch, region_ms)
    del batch
    phase_parity(run, res, lo)

    routes = {
        "weighted_gram_t1": ("gauss_tpu_torch/csrc/gram.cu",
                             "gauss_tpu/ops/pallas_gram.py:203"),
        "gather_rows": ("gauss_tpu_torch/csrc/gather.cu",
                        "gauss_tpu/ops/dma_gather.py:70"),
    }
    rows = []
    for kname, (src, replaces) in routes.items():
        if not os.path.exists(os.path.join(HERE, src)):
            raise AssertionError(f"missing kernel source {src}")
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kname],
                     **kernels[kname]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

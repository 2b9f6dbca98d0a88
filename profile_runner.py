#!/usr/bin/env python
"""Two measurements of gauss_tpu_torch's checkpointed runner on one CUDA
card, on chip_smoke.py's bench workload (the same cached panel, 40%
measured, prepare_mix, 1 Mb windows, the runner's chunks of whole
windows).

    python3 profile_runner.py [--snps N] [--rounds R]

1. stages -- why a chunk's z and info differ in their last bits from the
   same windows' rows of a whole-region call.  The resident impute
   kernel's stages (the correlation blocks: K1 and the region tail's
   block kernels; the Cholesky factorization; the triangular solve; the
   z and info kernel) run on the whole region's
   batch and on a slice of n of its windows (n = 1, the runner's chunk
   width, and 9: PyTorch's triangular solve loops cuBLAS trsm up to 8
   matrices and takes the batched routine above), each stage on the SAME
   inputs, the preceding stage's whole-batch output: printed per stage,
   whether the slice's result is bit-equal to the same windows of the
   whole batch's, and the largest difference.  Then the chunk's own batch
   (its own padded band heights) against the region's.
2. overlap -- what keeping one chunk's handle pending would save.  The
   runner fetches and writes each chunk before it prepares the next.
   gauss_tpu's runner instead dispatches chunk N+1
   (impute_region_async) before it fetches and writes chunk N.  R
   rounds of
   four variants run in turns on one prepared run (panel resident,
   kernels built, batches rebuilt per chunk): GenomeRunner.run() as it
   is, or pipelined_run() below, the same chunk work in gauss_tpu's
   order, each with the batch's uploads from pageable memory (what the
   engine does) or through pinned staging and non-blocking copies.  Per
   variant: the run's wall, the time inside the chunks' dispatches
   (tracer phase "chunk"), inside RegionHandle.result and inside the
   shard writes, and whether collect() is bit-equal to the first
   variant's.
"""

import argparse
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (CACHE, MEASURED_FRAC, WINDOW_BP,      # noqa: E402
                        WING_BP, log, phase_build, phase_device,
                        runner_maker)
from gauss_tpu_torch.models import genome                      # noqa: E402
from gauss_tpu_torch.models.genome import GenomeEngine        # noqa: E402
from gauss_tpu_torch.ops.region_tail import impute_finalize   # noqa: E402
from gauss_tpu_torch.ops.window_kernel import (                # noqa: E402
    _ResidentBlocks, full_f32_matmul)
from gauss_tpu_torch.utils.benchdata import (cached_panel,    # noqa: E402
                                             make_bench_input)
from gauss_tpu_torch.utils.timing import Tracer               # noqa: E402


def same(a, b):
    """"bit-equal" (NaN where both are NaN: a padded column's z is 0 / 0)
    or the largest |a - b| of two tensors."""
    if a.is_floating_point():
        both = a.isnan() & b.isnan()
        a, b = a.masked_fill(both, 0), b.masked_fill(both, 0)
    if torch.equal(a, b):
        return "bit-equal"
    return f"max|d| {float((a - b).abs().max()):.3e}"


def tail_stages(B11, rhs):
    """The impute tail of ops/window_kernel._impute_tail, stage by stage,
    each stage's output kept."""
    L, bad = torch.linalg.cholesky_ex(B11)
    Y = torch.linalg.solve_triangular(L, rhs, upper=False)
    z, info = impute_finalize(Y, bad)
    return dict(L=L, rhs=rhs, Y=Y, z=z, info=info)


def phase_stages(run, lo, hi, chunk_windows):
    spec = run.engine._spec(run.pop_sizes, run.wgts)
    b = run._region_batch(lo, hi, WINDOW_BP, WING_BP)
    W = len(b.plans)
    m_t0, u_t0, Z1, m_mask, u_mask = b.inputs
    blocks = _ResidentBlocks(spec, b.Mp, b.Up)
    with full_f32_matmul():
        B11, rhs = blocks(*b.arrays, m_t0, u_t0, Z1, m_mask, u_mask)
        full = tail_stages(B11, rhs)
        for n in sorted({1, chunk_windows, 9}):
            if n >= W:
                continue
            sl = slice(chunk_windows, chunk_windows + n) \
                if chunk_windows + n <= W else slice(0, n)
            B11s, rhss = blocks(*b.arrays, m_t0[sl], u_t0[sl], Z1[sl],
                                m_mask[sl], u_mask[sl])
            # batch slices keep each stage's own layout (the solve's
            # column-major right-hand side and output)
            L = torch.linalg.cholesky_ex(B11[sl])[0]
            Y = torch.linalg.solve_triangular(full["L"][sl], full["rhs"][sl],
                                              upper=False)
            z, info = impute_finalize(
                full["Y"][sl], torch.zeros(n, dtype=torch.int32,
                                           device=B11.device))
            log(f"stages, windows {sl.start}..{sl.stop - 1} as a batch of "
                f"{n} against the same windows in the batch of "
                f"{m_t0.shape[0]} (Mp={b.Mp}, Up={b.Up}), each stage on "
                f"the whole batch's inputs: blocks B11 "
                f"{same(B11s, B11[sl])}, rhs {same(rhss, rhs[sl])}; "
                f"cholesky_ex {same(L, full['L'][sl])}; solve_triangular "
                f"{same(Y, full['Y'][sl])}; impute_finalize z "
                f"{same(z, full['z'][sl])}, info "
                f"{same(info, full['info'][sl])}")
            del B11s, rhss, L, Y, z, info

        # the chunk's own batch: its own padded band heights
        a = b.plans[chunk_windows][0]
        c = b.plans[min(2 * chunk_windows, W) - 1][1]
        sl = slice(chunk_windows, min(2 * chunk_windows, W))
        own = run._region_batch(a, c, WINDOW_BP, WING_BP)
        o_m_t0, o_u_t0, o_Z1, o_m_mask, o_u_mask = own.inputs
        n = len(own.plans)
        o11, orhs = _ResidentBlocks(spec, own.Mp, own.Up)(
            *own.arrays, o_m_t0, o_u_t0, o_Z1, o_m_mask, o_u_mask)
        mp, up = min(b.Mp, own.Mp), min(b.Up, own.Up)
        ot = tail_stages(o11, orhs)
        # real rows only: the padded rows of a band differ by construction
        real = own.inputs[4][:n, :up] > 0
        log(f"stages, the chunk's own batch ({n} windows, Mp={own.Mp}, "
            f"Up={own.Up}) against the same windows of the region's "
            f"(Mp={b.Mp}, Up={b.Up}), leading {mp} x {mp} / {up} x {mp} "
            f"blocks: B11 {same(o11[:n, :mp, :mp], B11[sl][:, :mp, :mp])}, "
            f"B21 {same(orhs[:n, :mp, :up], rhs[sl][:, :mp, :up])}, L "
            f"{same(ot['L'][:n, :mp, :mp], full['L'][sl][:, :mp, :mp])}; "
            f"on the real unmeasured rows z "
            f"{same(ot['z'][:n, :up][real], full['z'][sl][:, :up][real])}"
            f", info "
            f"{same(ot['info'][:n, :up][real], full['info'][sl][:, :up][real])}")
    del full, B11, rhs, o11, orhs, ot
    run._res.clear()
    torch.cuda.empty_cache()


def pinned_to_device(a, device):
    """genome._to_device through pinned staging: the copy is queued and
    does not wait for the stream."""
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def pipelined_run(r, prep):
    """The runner's impute chunks in gauss_tpu's order: chunk N's fetch
    and shard write after chunk N+1's dispatch, one handle pending."""
    pending = None
    for cs in r.chunks.values():
        t0 = time.time()
        with r.tracer.phase("chunk", key=cs.key):
            h = prep.impute_region_async(cs.start_bp, cs.end_bp,
                                         window_bp=r.window_bp,
                                         wing_size=r.wing_size)
        cs.elapsed = time.time() - t0
        prev, pending = pending, (cs, h)
        for cs0, h0 in [prev] if prev else []:
            r._record_done(cs0, h0.result())
            r._save_manifest()
    r._record_done(pending[0], pending[1].result())
    r._save_manifest()
    return r.status()


def one_run(prep, make, name, pipelined, pinned):
    """One impute run over the region on the prepared run ``prep`` with
    its batches dropped: (wall, dispatch, result, write seconds, the
    collected frame)."""
    tracer = Tracer()
    r = make(name, tracer=tracer)
    r._run = prep
    prep._res.clear()
    spent = {"result": 0.0, "write": 0.0}

    real_result = genome.RegionHandle.result
    real_done = r._record_done
    real_upload = genome._to_device

    def result(h):
        t = time.perf_counter()
        out = real_result(h)
        spent["result"] += time.perf_counter() - t
        return out

    def done(cs, df):
        t = time.perf_counter()
        real_done(cs, df)
        spent["write"] += time.perf_counter() - t

    genome.RegionHandle.result = result
    r._record_done = done
    if pinned:
        genome._to_device = pinned_to_device
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        stats = pipelined_run(r, prep) if pipelined else r.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        genome.RegionHandle.result = real_result
        genome._to_device = real_upload
    if stats["done"] != len(r.chunks):
        raise AssertionError(f"{name}: {stats}")
    dispatch = sum(p.elapsed for p in tracer.phases if p.name == "chunk")
    if not pipelined:          # the runner's phase holds fetch and result
        dispatch -= spent["result"]
    return wall, dispatch, spent["result"], spent["write"], r.collect()


def phase_overlap(prep, make, rounds):
    variants = [("GenomeRunner.run, pageable uploads", False, False),
                ("pipelined loop, pageable uploads", True, False),
                ("GenomeRunner.run, pinned uploads", False, True),
                ("pipelined loop, pinned uploads", True, True)]
    one_run(prep, make, "warm", False, False)      # kernels built per shape
    rows = {v[0]: [] for v in variants}
    first = None
    for i in range(rounds):
        order = variants if i % 2 == 0 else variants[::-1]
        for j, (label, pipelined, pinned) in enumerate(order):
            *times, df = one_run(prep, make, f"r{i}_{j}", pipelined, pinned)
            rows[label].append(times)
            if first is None:
                first = df
            elif not (np.array_equal(df["z"], first["z"])
                      and np.array_equal(df["info"], first["info"])):
                raise AssertionError(f"{label}: collect() differs from the "
                                     f"first variant's")
    n = len(first)
    for label, runs in rows.items():
        walls = [t[0] for t in runs]
        med = lambda k: statistics.median(t[k] for t in runs) * 1e3
        log(f"overlap, {label}: run wall {[round(w * 1e3, 1) for w in walls]}"
            f" ms, median {med(0):.1f} ms; of it the chunks' dispatches "
            f"(batch build and launches) {med(1):.1f} ms, "
            f"RegionHandle.result (wait and frame) {med(2):.1f} ms, shard "
            f"writes {med(3):.1f} ms (medians of {len(runs)}); collect() "
            f"bit-equal to the first variant's ({n} rows)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--snps", type=int, default=64_000,
                    help="region length in SNPs (default: the bench "
                         "workload, 64,000)")
    ap.add_argument("--rounds", type=int, default=5,
                    help="rounds of the four variants (default 5)")
    args = ap.parse_args()

    dev, _ = phase_device()
    phase_build()
    store = cached_panel(CACHE, args.snps, bp_span=args.snps * 2000 // 3)
    inp = make_bench_input(store, MEASURED_FRAC)
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}
    lo = int(store.index["bp"].min())
    hi = int(store.index["bp"].max())
    engine = GenomeEngine(store, device=dev, device_linalg=True)
    prep = engine.prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    with tempfile.TemporaryDirectory(prefix="gauss_runner_") as tmp:
        make, n_windows, chunk_bp = runner_maker(engine, lo, hi, tmp)
        log(f"{n_windows} windows, chunks of {chunk_bp // WINDOW_BP}")
        phase_stages(prep, lo, hi, chunk_bp // WINDOW_BP)
        phase_overlap(prep, make, args.rounds)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Profile gauss_tpu_torch's region paths on one CUDA card.

    python3 profile_regions.py [--snps N] [--calls C] [--out FILE]

Prepares chip_smoke.py's bench workload (the same cached panel, 40%
measured, prepare_mix) and profiles each path with torch.profiler over
C calls, each ending in a synchronize, after one warm-up call:

- the region functions alone on their cached batch: impute, qcat, LD
  "i16tri" and LD "f32" (device work only, no host assembly);
- the impute solves alone on the batch's own blocks (B11 and
  [B21^T | Z1] as the region function hands them over): the port's
  kernel (region_tail.cholesky_solve, on fresh copies: it writes over
  its inputs, and the copies show as their own kernels) and, beside it,
  the library pair it replaced (cholesky_ex and solve_triangular), so
  that both breakdowns by kernel name come from one tree;
- the entry points ld_region ("i16tri", "f32"), qcat_region,
  impute_region, and impute_regions over 4 passes with 2 in flight.

Then it times the copy of the LD kernel's float64 output to the host
in turns, per fetch mode: straight into a fresh mapping pre-faulted by
the kernel (MAP_POPULATE: the engine's _fetch_flat), straight into a
fresh np.empty array (one page fault per page during the copy),
through pinned staging (_copy_to_host) and a host copy into a fresh
pageable array, and straight into one pageable array reused across
calls (no fresh pages: the rest is what fresh pages cost).

Per path it prints the wall per call under the profiler (host clock),
the device time per call (the CUDA kernels and copies the profiler
recorded), the busy share (device / wall) and the largest kernels.  For
the entry points it also prints the engine's host spans (ld.* and
qcat.*, torch.profiler.record_function in models/genome.py) per call,
and the rest of the same wall as "other", so the parts sum to the wall.
The unprofiled wall (median of C) is printed beside it.  --out writes
the same report with more kernels per path.
"""

import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (CACHE, MEASURED_FRAC, WINDOW_BP,      # noqa: E402
                        WING_BP, phase_build, phase_device)
from gauss_tpu_torch.models.genome import (GenomeEngine,       # noqa: E402
                                           _copy_to_host, _fetch_flat)
from gauss_tpu_torch.ops import region_tail                    # noqa: E402
from gauss_tpu_torch.ops.window_kernel import (                # noqa: E402
    _ResidentBlocks, full_f32_matmul)
from gauss_tpu_torch.utils.benchdata import (cached_panel,    # noqa: E402
                                             make_bench_input)


def _device_us(e):
    """Self device time of one averaged profiler entry, microseconds."""
    v = getattr(e, "self_device_time_total", None)
    return v if v is not None else e.self_cuda_time_total


def profiled(fn, calls):
    """(wall ms per call under the profiler, device ms per call, kernels
    [(ms per call, name)] largest first, host spans {name: ms per call},
    unprofiled wall ms per call, median of ``calls``)."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(calls):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t) / calls
    kernels, spans = [], {}
    for e in prof.key_averages():
        if e.key.startswith(("ld.", "qcat.")):
            # a span is also listed on the device (the stretch of its
            # kernels); that is not device time of its own
            if e.device_type == DeviceType.CPU:
                spans[e.key] = e.cpu_time_total / 1e3 / calls
        elif e.device_type == DeviceType.CUDA:
            kernels.append((_device_us(e) / 1e3 / calls, e.key))
    kernels.sort(reverse=True)
    device = sum(ms for ms, _ in kernels)
    return (wall * 1e3, device, kernels, spans,
            statistics.median(walls) * 1e3)


def report(label, res, n_kernels):
    wall, device, kernels, spans, plain_wall = res
    lines = [f"== {label}: wall {wall:.3f} ms/call under the profiler "
             f"({plain_wall:.3f} ms without), device {device:.3f} ms/call, "
             f"busy {device / wall:.3f}"]
    for ms, name in kernels[:n_kernels]:
        lines.append(f"   {ms:9.3f} ms  {name[:110]}")
    if spans:
        for name in sorted(spans):
            lines.append(f"   host span {name}: {spans[name]:.3f} ms")
        lines.append(f"   host other (wall - spans): "
                     f"{wall - sum(spans.values()):.3f} ms")
    return lines


def ld_copies(ld, calls):
    """Per LD fetch mode, ms per copy of the kernel's float64 output to
    the host (median of ``calls`` rounds, the variants in turns, their
    order reversed every other round), and the bytes copied."""
    lines = []
    for fetch, (fn, args, _) in ld.items():
        out = fn(*args)
        torch.cuda.synchronize()
        reused = np.ones(out.numel())

        def staged():
            host, ready = _copy_to_host(out)
            ready.synchronize()
            return host.numpy().copy()

        def fresh():
            host = np.empty(out.numel())
            torch.from_numpy(host).copy_(out)
            return host

        variants = {
            "pre-faulted pageable (_fetch_flat, MAP_POPULATE)":
                lambda: _fetch_flat([out]),
            "fresh pageable (np.empty)": fresh,
            "pinned staging + host copy": staged,
            "reused pageable array": lambda: torch.from_numpy(
                reused).copy_(out),
        }
        for f in variants.values():
            f()
        walls = {k: [] for k in variants}
        for r in range(calls):
            for k in (list(variants) if r % 2 == 0
                      else list(variants)[::-1]):
                t = time.perf_counter()
                variants[k]()
                walls[k].append(1e3 * (time.perf_counter() - t))
        lines.append(f"== LD {fetch} copy to the host, "
                     f"{out.numel() * out.element_size()} B, ms (median of "
                     f"{calls}, in turns): " + ", ".join(
                         f"{k} {statistics.median(v):.3f}"
                         for k, v in walls.items()))
        del out
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--snps", type=int, default=64_000,
                    help="region length in SNPs (default: the bench "
                         "workload, 64,000)")
    ap.add_argument("--calls", type=int, default=5,
                    help="profiled calls per path (default 5)")
    ap.add_argument("--out", help="also write the report, with the 15 "
                                  "largest kernels per path, here")
    args = ap.parse_args()

    dev, _ = phase_device()
    phase_build()
    store = cached_panel(CACHE, args.snps, bp_span=args.snps * 2000 // 3)
    inp = make_bench_input(store, MEASURED_FRAC)
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}
    lo = int(store.index["bp"].min())
    hi = int(store.index["bp"].max())
    run = GenomeEngine(store, device=dev, device_linalg=True).prepare_mix(
        inp, pop_wgt, af1_cutoff=0.01)
    run.impute_region(lo, hi, window_bp=WINDOW_BP, wing_size=WING_BP)
    run.ld_region(lo, hi, window_bp=WINDOW_BP)

    b = run._region_batch(lo, hi, WINDOW_BP, WING_BP)
    imp = run._kernel_fn("impute", b.Mp, b.Up)
    qc = run._kernel_fn("qcat", b.Mp, b.Up)
    windows = run._ld_windows(lo, hi, WINDOW_BP)
    ld = {f: run._ld_batch(windows, f) for f in ("i16tri", "f32")}
    m_t0, u_t0, Z1, m_mask, u_mask = b.inputs
    with full_f32_matmul():
        B11, rhs = _ResidentBlocks(run.engine._spec(run.pop_sizes, run.wgts),
                                   b.Mp, b.Up)(*b.arrays, m_t0, u_t0, Z1,
                                               m_mask, u_mask)

    Bk, Rk = B11.clone(), rhs.clone()

    def kernel_solves():
        with full_f32_matmul():
            Bk.copy_(B11)
            Rk.copy_(rhs)
            return region_tail.cholesky_solve(Bk, Rk)

    def library_solves():
        with full_f32_matmul():
            L = torch.linalg.cholesky_ex(B11)[0]
            return torch.linalg.solve_triangular(L, rhs, upper=False)

    paths = [
        ("impute region fn", lambda: imp(*b.arrays, *b.inputs, *b.compact)),
        ("impute solves alone: cholesky_solve (with the copies of its "
         "inputs)", kernel_solves),
        ("impute solves alone: the library pair (cholesky_ex + "
         "solve_triangular on its blocks)", library_solves),
        ("qcat region fn", lambda: qc(*b.arrays, *b.inputs)),
        ("LD i16tri region fn", lambda: ld["i16tri"][0](*ld["i16tri"][1])),
        ("LD f32 region fn", lambda: ld["f32"][0](*ld["f32"][1])),
        ("ld_region i16tri", lambda: run.ld_region(lo, hi, WINDOW_BP,
                                                   fetch="i16tri")),
        ("ld_region f32", lambda: run.ld_region(lo, hi, WINDOW_BP,
                                                fetch="f32")),
        ("qcat_region", lambda: run.qcat_region(lo, hi, WINDOW_BP,
                                                WING_BP)),
        ("impute_region", lambda: run.impute_region(lo, hi, WINDOW_BP,
                                                    WING_BP)),
        ("impute_regions x4, 2 in flight", lambda: [
            r for r in run.impute_regions([(lo, hi)] * 4, WINDOW_BP,
                                          WING_BP, depth=2)]),
    ]
    full = []
    for label, fn in paths:
        res = profiled(fn, args.calls)
        print("\n".join(report(label, res, 6)), flush=True)
        full += report(label, res, 15)
    copies = ld_copies(ld, max(args.calls, 10))
    print("\n".join(copies), flush=True)
    full += copies
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(full) + "\n")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Time K1, K2, K3, K4 and the region tail's Cholesky solve on one CUDA
card at the main path's and the probe's shapes, beside another build of
the same kernels and one PyTorch call for the same work.

    python3 bench_kernels.py [--other DIR] [--reps N] [--out FILE]
                             [--solve-only]

Inputs are made on the card from a seed at the bench region's shapes: 43
windows over the 33KG subject layout (29 populations, 33,153 subjects,
each population padded to 64 columns: S = 34,176):

- K1 impute/qcat mm: 1280-row bands, sym; um: 960-row bands against
  the 1280-row ones; LD mm: 640-row bands, sym, at band offsets that are
  not multiples of 64 (as the LD path's are);
- K2: the row ids of an aligned impute batch into a 64,000-row panel
  (40% of rows measured, 1,500 SNPs per Mb): per window, the measured
  rows of its 2 Mb span padded to 1280 with -1, then the unmeasured rows
  of its 1 Mb core padded to 960.  Measured rows recur in two windows, as
  on the main path.

- K3 at K1's yardstick shape (chip_smoke phase 9): A 55,040 x 34,176 and
  B 1,280 x 34,176 in [-2, 2]; its product on the packed operands and its
  packing pass apart;
- K4 at the largest block of 43,008-value rows that fits one cluster,
  int8 and int4, clusters of 1 and 8 (chip_smoke phase 9), timed on the
  device alone (chip_smoke.device_ms: a call's host path is longer than
  its device work);
- cholesky_solve (ops/region_tail) at Mp = 1280, K = 961 over W = 43
  windows (the region slab), 7 (a runner chunk) and 1, and at W = 1, K =
  897 (the device impute_window's own shape): B11 the correlations over
  640 subjects of AR(1) rows (rho 0.8) with the ridge 1.1 on the diagonal,
  the right-hand side their correlations with K - 1 more rows and a z
  column; beside the library pair cholesky_ex + solve_triangular in the
  same run, both against a float64 solve (normwise), timed on fresh copies
  of its inputs (it solves in place), with its bound: 3 FLOP at the TF32
  peak (the kernel's 3xTF32 products, chip_smoke.solve_bounds), the f32
  and byte figures beside.  Not timed against --other.  --solve-only
  times it alone.

For each it prints the kernel's time (CUDA events, median of --reps after
a warm-up), its bound (chip_smoke.bound: operations at the int8 peak or
bytes at the HBM rate, whichever is longer) and one PyTorch call for the
same work (torch._int_mm, torch.index_select, x.sum(1)).

--other DIR: the root of another checkout (for example a parent commit
unpacked with git archive).  Its gauss_tpu_torch/csrc/*.cu are built with
this tree's nvcc flags, its kernels are timed in turns with this tree's
(other, this, this, other), and their outputs are compared.  A build
without gauss_weighted_gram_smem predates the source-ordered K2 and is
called with that K2's arguments (G, idx, out, n, S, R, stream).
"""

import argparse
import contextlib
import ctypes
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (bound, cuda_ms, cuda_ms_fresh,        # noqa: E402
                        device_ms, k1_bound, k1_library_ms, log, normwise,
                        phase_build, phase_device, solve_bounds)
from gauss_tpu_torch.core.stats import full_f32_matmul         # noqa: E402
from gauss_tpu_torch.ops import _build, gather, gram           # noqa: E402
from gauss_tpu_torch.ops import region_tail                    # noqa: E402
from gauss_tpu_torch.probes import probe7_int4 as p7           # noqa: E402
from gauss_tpu_torch.utils.benchdata import POPS_33KG          # noqa: E402

W = 43


def impute_like_rows(R=64_000, Mp=1280, Up=960, seed=0):
    """int32 row ids shaped like the aligned impute batch (docstring)."""
    rng = np.random.default_rng(seed)
    measured = rng.random(R) < 0.4
    mi, ui = np.flatnonzero(measured), np.flatnonzero(~measured)
    bands = []
    for rows, pad, lo, hi in (
            [(mi, Mp, 1500 * w - 750, 1500 * w + 2250) for w in range(W)]
            + [(ui, Up, 1500 * w, 1500 * w + 1500) for w in range(W)]):
        r = rows[(rows >= lo) & (rows < hi)][:pad]
        bands.append(np.concatenate([r, np.full(pad - len(r), -1)]))
    return np.concatenate(bands).astype(np.int32)


def build_other(root):
    """ctypes library of another checkout's kernels, built with this
    tree's nvcc flags."""
    srcs = _build._sources(os.path.join(root, "gauss_tpu_torch", "csrc"))
    out = os.path.join(root, "gauss_tpu_torch", "_build")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libgauss_kernels_other.so")
    for line in _build.compile_library(srcs, so).splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  other ptxas: {line.strip()}")
    lib = ctypes.CDLL(so)
    for name, argtypes in _build._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    if not hasattr(lib, "gauss_weighted_gram_smem"):
        P, L = ctypes.c_void_p, ctypes.c_longlong
        lib.gauss_gather_rows.argtypes = [P, P, P, L, L, L, P]
        lib.unordered_gather = True
    lib.gauss_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gauss_cuda_error_string.restype = ctypes.c_char_p
    return lib


@contextlib.contextmanager
def using(lib):
    """The wrappers launch ``lib``'s kernels inside the block."""
    own = _build.library()
    _build._LIB = lib
    try:
        yield
    finally:
        _build._LIB = own


def turns(fn, other, reps, other_fn=None, timer=cuda_ms):
    """Median ms of fn() with this tree's kernels and, given another
    library, of other_fn() (default fn) with its kernels, in turns other,
    this, this, other: (this ms, other ms or None), each the mean of its
    two turns.  ``timer(fn, reps)`` gives ms (default: CUDA events)."""
    this = []
    prev = []
    for lib in ([other, None, None, other] if other else [None]):
        with using(lib or _build.library()):
            if lib:
                prev.append(timer(other_fn or fn, reps))
            else:
                this.append(timer(fn, reps))
    return (sum(this) / len(this),
            sum(prev) / len(prev) if prev else None)


def other_gather(lib, G, idx):
    """K2 of another build on (G, idx): its wrapper call, or for a build
    before the source-ordered K2 its own launcher's arguments."""
    if not getattr(lib, "unordered_gather", False):
        return lambda: gather.gather_rows(G, idx)
    out = torch.empty((idx.shape[0], G.shape[1]), dtype=torch.int8,
                      device=G.device)

    def run():
        _build.check(lib.gauss_gather_rows(
            G.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
            G.shape[1], G.shape[0], torch.cuda.current_stream().cuda_stream),
            "other gather_rows")
        return out
    return run


def bench_k3(dev, g, other, reps):
    """K3's product on packed operands and its packing pass at K1's
    yardstick shape, in turns with the other build; outputs compared."""
    M, N, K = 43 * 1280, 1280, 34176
    A = torch.randint(-2, 3, (M, K), dtype=torch.int8, device=dev,
                      generator=g)
    B = torch.randint(-2, 3, (N, K), dtype=torch.int8, device=dev,
                      generator=g)
    width = p7.k3_width(K)
    pa, pb = p7._pack(A, width), p7._pack(B, width)
    ops = 2.0 * M * N * K
    ms, other_ms = turns(lambda: p7._int4_dot_packed(pa, pb), other, reps)
    pack_ms, other_pack = turns(
        lambda: (p7._pack(A, width), p7._pack(B, width)), other, reps)
    lib_ms = cuda_ms(lambda: torch._int_mm(A, B.t()), reps)
    b_ms, b_by = bound(ops, (M + N) * width + 4.0 * M * N)
    pk_ms, pk_by = bound(0.0, (M + N) * (K + width))
    row = dict(product_ms=ms, other_product_ms=other_ms, bound_ms=b_ms,
               bound_by=b_by, pack_ms=pack_ms, other_pack_ms=other_pack,
               pack_bound_ms=pk_ms, library_ms=lib_ms,
               share_of_bound=b_ms / ms)
    msg = (f"K3 M={M} N={N} K={K}: product {ms:.3f} ms "
           f"({ops / ms / 1e9:.1f} TOP/s), bound {b_ms:.3f} ms ({b_by}) = "
           f"{b_ms / ms:.1%}; pack {pack_ms:.3f} ms, bound {pk_ms:.3f} ms "
           f"({pk_by}) = {pk_ms / pack_ms:.1%}; torch._int_mm "
           f"{lib_ms:.3f} ms")
    if other:
        got = p7._int4_dot_packed(pa, pb)
        with using(other):
            same = torch.equal(got, p7._int4_dot_packed(pa, pb))
        row["equal_other"] = bool(same)
        msg += (f"; other build: product {other_ms:.3f} ms "
                f"({other_ms / ms:.2f}x), pack {other_pack:.3f} ms, "
                f"outputs equal={same}")
        if not same:
            raise AssertionError("K3 differs from the other build's")
        del got
    log(msg)
    del A, B, pa, pb
    torch.cuda.empty_cache()
    return row


def bench_k4(dev, other):
    """K4 at the largest block that fits (int8, int4; clusters of 1 and
    8), on the device alone, in turns with the other build, beside
    x.sum(1) on the int8 block."""
    rng = np.random.default_rng(0)
    x8 = torch.from_numpy(rng.integers(0, 3, (160, p7.ROW),
                                       dtype=np.int8)).to(dev)
    out = {}
    for dtype in ("int8", "int4"):
        blk = x8 if dtype == "int8" else p7.pack_int4(x8)
        for c in (1, 8):
            R = p7.capacity(blk.shape[1], c)[0] * c
            x, xb = blk[:R].contiguous(), x8[:R].contiguous()
            timer = lambda f, reps: device_ms(f)[0]
            ms, other_ms = turns(lambda: p7.resident_rowsum(x, dtype, c),
                                 other, 0, timer=timer)
            lib_ms = device_ms(lambda: xb.sum(1, dtype=torch.int32))[0]
            b_ms, b_by = bound(0.0, R * blk.shape[1] + R * 128 * 4.0)
            out[f"{dtype} cluster {c}"] = dict(
                rows=R, device_ms=ms, other_device_ms=other_ms,
                bound_ms=b_ms, library_device_ms=lib_ms)
            log(f"K4 {dtype} cluster {c}, {R} rows: {ms:.4f} ms on the "
                f"device, bound {b_ms:.4f} ms ({b_by}) = {b_ms / ms:.1%}, "
                f"x.sum(1) {lib_ms:.4f} ms"
                + (f"; other build {other_ms:.4f} ms" if other else ""))
    return out


def solve_blocks(dev, g, nw, Mp=1280, Up=960, n=640, rho=0.8):
    """(B11 [nw, Mp, Mp], rhs [nw, Mp, Up + 1] column-major) as the
    docstring says, made on the card from ``g``."""
    R = Mp + Up
    eps = torch.randn((nw, R, n), device=dev, generator=g)
    X = torch.empty_like(eps)
    X[:, 0] = eps[:, 0]
    for r in range(1, R):
        X[:, r] = rho * X[:, r - 1] + (1 - rho * rho) ** 0.5 * eps[:, r]
    X = X - X.mean(dim=2, keepdim=True)
    X = X / X.norm(dim=2, keepdim=True)
    k = min(Mp, Up)                     # every other row measured, then
    m = torch.cat([torch.arange(0, 2 * k, 2), torch.arange(2 * k, R)])[:Mp]
    u = torch.ones(R, dtype=torch.bool)  # the rest
    u[m] = False
    Xm, Xu = X[:, m.to(dev)], X[:, u.to(dev)]
    with full_f32_matmul():
        B11 = torch.bmm(Xm, Xm.transpose(1, 2))
        B21 = torch.bmm(Xu, Xm.transpose(1, 2))
    B11.diagonal(dim1=1, dim2=2).fill_(1.1)
    rhs = torch.empty((nw, Up + 1, Mp), device=dev)
    rhs[:, :Up] = B21
    rhs[:, Up] = 1.5 * torch.randn((nw, Mp), device=dev, generator=g)
    return B11, rhs.transpose(1, 2)


def bench_solve(dev, g, reps):
    """cholesky_solve at W = 43, 7 and 1 (K = 961) and at W = 1, K = 897
    beside the library pair."""
    out = {}
    for nw, Up in ((W, 960), (7, 960), (1, 960), (1, 896)):
        B11, rhs = solve_blocks(dev, g, nw, Up=Up)
        Bk, Rk = B11.clone(), rhs.clone()
        nb, Mp, K = rhs.shape
        with full_f32_matmul():
            Y = region_tail.cholesky_solve(Bk, Rk)[0]
            pY = region_tail.cholesky_solve_plain(B11, rhs)[0]
            L64 = torch.linalg.cholesky_ex(B11.double())[0]
            Y64 = torch.linalg.solve_triangular(L64, rhs.double(),
                                                upper=False)
            acc, lib_acc = normwise(Y.double(), Y64), normwise(pY.double(),
                                                               Y64)
            del Y, pY, L64, Y64

            def fresh():
                Bk.copy_(B11)
                Rk.copy_(rhs)

            ms = cuda_ms_fresh(fresh, lambda: region_tail.cholesky_solve(
                Bk, Rk), reps)
            lib_ms = cuda_ms(lambda: region_tail.cholesky_solve_plain(
                B11, rhs), reps)
        t_ms, f_ms, b_ms, gflop, mb = solve_bounds(nw, Mp, K, False)
        out[f"W={nw} K={K}"] = dict(
            ms=ms, bound_ms=t_ms, bound_by="operations", f32_bound_ms=f_ms,
            bytes_bound_ms=b_ms, share_of_bound=t_ms / ms, library_ms=lib_ms,
            err_f64=acc, library_err_f64=lib_acc)
        log(f"cholesky_solve W={nw} Mp={Mp} K={K}: {ms:.3f} ms, bound "
            f"{t_ms:.3f} ms (3 x {gflop:.2f} GFLOP at the TF32 peak) = "
            f"{t_ms / ms:.1%}; f32 bound {f_ms:.3f} ms = {f_ms / ms:.1%}, "
            f"bytes {b_ms:.3f} ms ({mb:.1f} MB); the library pair "
            f"{lib_ms:.3f} ms ({lib_ms / ms:.2f}x the kernel); normwise "
            f"against float64 {acc:.3e}, the pair's {lib_acc:.3e}")
        del B11, rhs, Bk, Rk
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of another checkout whose "
                                    "kernels are timed in turns")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--solve-only", action="store_true",
                    help="time cholesky_solve alone")
    args = ap.parse_args()

    dev, name = phase_device()
    phase_build()
    if args.solve_only:
        g = torch.Generator(device=dev).manual_seed(0)
        emit({"device": name,
              "cholesky_solve": bench_solve(dev, g, args.reps)}, args.out)
        return
    other = build_other(args.other) if args.other else None
    g = torch.Generator(device=dev).manual_seed(0)
    sizes = tuple(n for _, n, _ in POPS_33KG)
    padded = tuple(-(-m // gram.K_CHUNK) * gram.K_CHUNK for m in sizes)
    wgts = (1.0 / len(sizes),) * len(sizes)
    S = sum(padded)
    real = torch.zeros(S, dtype=torch.int8, device=dev)
    lo = 0
    for m, p in zip(sizes, padded):
        real[lo:lo + m] = 1
        lo += p

    def panel(rows):
        return torch.randint(-2, 3, (rows, S), dtype=torch.int8,
                             device=dev, generator=g) * real

    def offs(step, n):
        return (torch.arange(n, device=dev) * step).round().to(torch.int32)

    Xm, Xu, Xl = panel(W * 1280), panel(W * 960), panel(26_240)
    cases = {
        "mm": (Xm, Xm, offs(1280, W), offs(1280, W), 1280, 1280, True),
        "um": (Xu, Xm, offs(960, W), offs(1280, W), 960, 1280, False),
        "LD mm": (Xl, Xl, offs((26_240 - 640) / (W - 1), W),
                  offs((26_240 - 640) / (W - 1), W), 640, 640, True),
    }
    results = {"device": name, "k1": {}, "k2": {}}
    for label, (A, B, a0, b0, nx, ny, sym) in cases.items():
        k1 = (A, B, sizes, padded, wgts, a0, b0, nx, ny, sym)
        ms, other_ms = turns(lambda: gram.weighted_gram_t1(*k1), other,
                             args.reps)
        b_ms, b_by = k1_bound(W, nx, ny, sum(sizes), sym)
        lib_ms = k1_library_ms(A, B, a0, b0, nx, ny, args.reps)
        row = dict(ms=ms, other_ms=other_ms, bound_ms=b_ms, bound_by=b_by,
                   library_ms=lib_ms, share_of_bound=b_ms / ms)
        msg = (f"K1 {label}: W={W} nx={nx} ny={ny} S={S}"
               f"{' sym' if sym else ''}: {ms:.3f} ms, bound {b_ms:.3f} ms "
               f"({b_by}) = "
               f"{b_ms / ms:.1%}, torch._int_mm {lib_ms:.3f} ms")
        if other:
            got = gram.weighted_gram_t1(*k1)
            with using(other):
                ref = gram.weighted_gram_t1(*k1)
            if sym:
                got, ref = torch.tril(got), torch.tril(ref)
            row["max_abs_diff_other"] = float((got - ref).abs().max())
            del got, ref
            msg += (f"; other build {other_ms:.3f} ms "
                    f"({other_ms / ms:.2f}x), max abs diff "
                    f"{row['max_abs_diff_other']:.3e}")
        log(msg)
        results["k1"][label] = row
        torch.cuda.empty_cache()
    del Xm, Xu, Xl, cases

    G = panel(64_000)
    idx = torch.from_numpy(impute_like_rows()).to(dev)
    other_fn = other_gather(other, G, idx) if other else None
    ms, other_ms = turns(lambda: gather.gather_rows(G, idx), other,
                         args.reps, other_fn)
    if other:
        with using(other):
            theirs = other_fn().clone()
        if not torch.equal(theirs, gather.gather_rows(G, idx)):
            raise AssertionError("K2 differs from the other build's")
        del theirs
    clamped = idx.clamp(min=0)
    lib_ms = cuda_ms(lambda: torch.index_select(G, 0, clamped), args.reps)
    n_real = int((idx >= 0).sum())
    n_distinct = int(torch.unique(idx[idx >= 0]).numel())
    b_ms, b_by = bound(0.0, (n_distinct + idx.shape[0]) * S)
    results["k2"]["impute-like batch"] = dict(
        ms=ms, other_ms=other_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=lib_ms, share_of_bound=b_ms / ms)
    log(f"K2: N={idx.shape[0]} ({idx.shape[0] - n_real} sentinels, "
        f"{n_distinct} distinct rows) S={S}: "
        f"{ms:.3f} ms, bound {b_ms:.3f} ms ({b_by}) = {b_ms / ms:.1%}, "
        f"torch.index_select {lib_ms:.3f} ms"
        + (f"; other build {other_ms:.3f} ms" if other else ""))
    del G, idx, clamped
    torch.cuda.empty_cache()
    results["k3"] = bench_k3(dev, g, other, args.reps)
    results["k4"] = bench_k4(dev, other)
    results["cholesky_solve"] = bench_solve(dev, g, args.reps)
    emit(results, args.out)


def emit(results, out):
    """The results as one JSON line, and into ``out`` when given."""
    print(json.dumps(results), flush=True)
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()

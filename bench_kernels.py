#!/usr/bin/env python
"""Time K1 and K2 on one CUDA card at the main path's shapes, beside
another build of the same kernels and one PyTorch call for the same work.

    python3 bench_kernels.py [--other DIR] [--reps N] [--out FILE]

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

For each it prints the kernel's time (CUDA events, median of --reps after
a warm-up), its bound (chip_smoke.bound: operations at the int8 peak or
bytes at the HBM rate, whichever is longer) and one PyTorch call for the
same work (torch._int_mm, torch.index_select).

--other DIR: the root of another checkout (for example a parent commit
unpacked with git archive).  Its gauss_tpu_torch/csrc/*.cu are built with
this tree's nvcc flags, its K1 and K2 are timed in turns with this tree's
(other, this, this, other), and their outputs are compared.  A build
without gauss_weighted_gram_smem predates the source-ordered K2 and is
called with that K2's arguments (G, idx, out, n, S, R, stream).
"""

import argparse
import contextlib
import ctypes
import glob
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (bound, cuda_ms, k1_bound,              # noqa: E402
                        k1_library_ms, log, phase_build, phase_device)
from gauss_tpu_torch.ops import _build, gather, gram           # noqa: E402
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
    srcs = sorted(glob.glob(os.path.join(root, "gauss_tpu_torch", "csrc",
                                         "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {root}")
    out = os.path.join(root, "gauss_tpu_torch", "_build")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libgauss_kernels_other.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                           *srcs], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {root}:\n{proc.stderr}")
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "Compiling entry" in line:
            log(f"  other ptxas: {line.strip()}")
    lib = ctypes.CDLL(so)
    lib.gauss_weighted_gram_t1.argtypes = \
        _build._SIGNATURES["gauss_weighted_gram_t1"]
    lib.gauss_weighted_gram_t1.restype = ctypes.c_int
    lib.gauss_gather_rows.argtypes = _build._SIGNATURES["gauss_gather_rows"]
    lib.gauss_gather_rows.restype = ctypes.c_int
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


def turns(fn, other, reps, other_fn=None):
    """Median ms of fn() with this tree's kernels and, given another
    library, of other_fn() (default fn) with its kernels, in turns other,
    this, this, other: (this ms, other ms or None), each the mean of its
    two turns."""
    this = []
    prev = []
    for lib in ([other, None, None, other] if other else [None]):
        with using(lib or _build.library()):
            if lib:
                prev.append(cuda_ms(other_fn or fn, reps))
            else:
                this.append(cuda_ms(fn, reps))
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", help="root of another checkout whose "
                                    "kernels are timed in turns")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()

    dev, name = phase_device()
    phase_build()
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
    print(json.dumps(results), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""How far a device mesh moves imputed z at full width, beside how far
K1's own f32 fold moves it, on one CUDA card.

    python3 profile_mesh.py [--snps N] [--shapes 1x2,2x2,1x4]

On chip_smoke.py's bench workload (the same cached panel, 40% measured,
prepare_mix, 1 Mb windows with 500 kb wings) it runs impute_region

- on one device (K1's fold: per-segment exact int32 sums folded into f32
  inside the kernel);
- on each mesh over the repeated card (K1 per subject shard, the f32
  partials of T1 added on the lead);
- with K1's plain version instead (float64 products and one rounding to
  f32: the exact T1 rounded once), on one device and on a (1 x 2) mesh;
- on a (1 x 2) mesh whose partials are added in float64,

and prints max|dz|, its 99th percentile, max|dz| / max(1, |z|) and
max|dinfo| of each pair, with the card's name and power limit.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from chip_smoke import (CACHE, MEASURED_FRAC, WINDOW_BP,      # noqa: E402
                        WING_BP, log, phase_build, phase_device)
from gauss_tpu_torch.models.genome import GenomeEngine        # noqa: E402
from gauss_tpu_torch.ops import gram                          # noqa: E402
from gauss_tpu_torch.ops import window_kernel as wk           # noqa: E402
from gauss_tpu_torch.parallel.mesh import make_mesh           # noqa: E402
from gauss_tpu_torch.utils.benchdata import (cached_panel,    # noqa: E402
                                             make_bench_input)


def region(engine, inp, pop_wgt, lo, hi):
    run = engine.prepare_mix(inp, pop_wgt, af1_cutoff=0.01)
    out = run.impute_region(lo, hi, window_bp=WINDOW_BP, wing_size=WING_BP)
    del run
    torch.cuda.empty_cache()
    return out


def diff(a, b, what):
    dz = np.abs(a["z"].to_numpy() - b["z"].to_numpy())
    di = np.abs(a["info"].to_numpy() - b["info"].to_numpy())
    z = np.abs(b["z"].to_numpy())
    log(f"{what}: max|dz| {dz.max():.3e}, p99 {np.quantile(dz, 0.99):.3e}, "
        f"max|dz| / max(1, |z|) {(dz / np.maximum(1.0, z)).max():.3e} "
        f"(|z| {z[np.argmax(dz)]:.3f} at the max), max|dinfo| "
        f"{di.max():.3e}; {(dz > 1e-5).sum()} of {len(dz)} rows above 1e-5")


def f64_partials(self, X, Y, x0, y0, nx, ny, sym=False):
    """_ResidentBlocks._t1 with the shards' partials added in float64."""
    out = None
    for Xj, Yj in zip(X, Y):
        d = Xj.device
        t = gram.weighted_gram_t1(Xj, Yj, *self.segs, x0.to(d), y0.to(d),
                                  nx, ny, sym=sym).double()
        out = t if out is None else out + t.to(x0.device)
    return out.float()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--snps", type=int, default=64_000)
    ap.add_argument("--shapes", default="1x2,2x2,1x4")
    args = ap.parse_args()
    dev, _ = phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = True
    store = cached_panel(CACHE, args.snps, bp_span=args.snps * 2000 // 3)
    inp = make_bench_input(store, MEASURED_FRAC)
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}
    lo, hi = int(store.index["bp"].min()), int(store.index["bp"].max())
    t = time.perf_counter()

    def on(shape):
        n = shape[0] * shape[1]
        return GenomeEngine(store, mesh=make_mesh(*shape, devices=[dev] * n))

    one = region(GenomeEngine(store, dev, device_linalg=True), inp, pop_wgt,
                 lo, hi)
    meshes = {}
    for s in args.shapes.split(","):
        shape = tuple(int(x) for x in s.split("x"))
        meshes[shape] = region(on(shape), inp, pop_wgt, lo, hi)
        diff(meshes[shape], one, f"mesh {s} against one device")

    real = gram.weighted_gram_t1
    gram.weighted_gram_t1 = gram.weighted_gram_t1_plain
    try:
        exact = region(GenomeEngine(store, dev, device_linalg=True), inp,
                       pop_wgt, lo, hi)
        exact12 = region(on((1, 2)), inp, pop_wgt, lo, hi)
    finally:
        gram.weighted_gram_t1 = real
    diff(one, exact, "one device (K1's fold) against the exact T1 rounded "
         "once")
    for shape, got in meshes.items():
        diff(got, exact, f"mesh {shape[0]}x{shape[1]} against the exact T1 "
             f"rounded once")
    diff(exact12, exact, "mesh 1x2 of exact partials against the exact T1 "
         "rounded once")

    real_t1 = wk._ResidentBlocks._t1
    wk._ResidentBlocks._t1 = lambda self, X, Y, *a, **k: (
        real_t1(self, X, Y, *a, **k) if isinstance(X, torch.Tensor)
        else f64_partials(self, X, Y, *a, **k))
    try:
        f64sum = region(on((1, 2)), inp, pop_wgt, lo, hi)
    finally:
        wk._ResidentBlocks._t1 = real_t1
    diff(f64sum, one, "mesh 1x2, partials added in float64, against one "
         "device")
    diff(f64sum, exact, "mesh 1x2, partials added in float64, against the "
         "exact T1 rounded once")
    log(f"profile_mesh: {time.perf_counter() - t:.1f}s after the panel")


if __name__ == "__main__":
    main()

#!/usr/bin/env python
"""Time jepeg / jepegmix's gene path on one CUDA card, for this checkout
or another one.

    python3 profile_genes.py [--root DIR]

Prepares chip_smoke.py's phase-8 workload (smoke_common: the bench panel
of MAIN_SNPS SNPs from .bench_cache/, made if missing; MEASURED_FRAC
measured; N_GENES genes x GENE_SNPS annotated SNPs) with the
gauss_tpu_torch package under DIR (default: this checkout), then for
jepegmix (the 29 populations, equal weights) and jepeg (STUDY_POP):

- the gene statistics on the card: gene_stats_resident over every gene,
  CUDA events, median of GENE_REPS calls after a warm-up (host work and
  the result's copy included), as chip_smoke.py's phase 8 times it;
- jepeg_region's wall, median of GENE_REPS calls, and genes per second;
- the CUDA kernels and memory copies torch.profiler records over one
  jepeg_region call, per gene bucket, the kernels' device time, and that
  of the two gene kernels (gene_partials_kernel, gene_tail_kernel)
  summed over the call's buckets.

Each mode ends in one JSON line ({"root", "mode", "gene_stats_ms",
"wall_ms", "genes_per_s", "buckets", "kernels", "copies",
"kernel_device_ms", "partials_device_ms", "tail_device_ms", "card"}).  To compare two trees, run it in turns in
one call (other, this, this, other), each in its own process: unpack the
other tree with `git archive <commit> | tar -x -C scratch_archive/parent`
and pass --root scratch_archive/parent.  Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from smoke_common import (GENE_REPS, MAIN_SNPS, MEASURED_FRAC, STUDY_POP,
                          cuda_ms, device_ms, gene_annotation, host_wall)

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(HERE, ".bench_cache")


def log(msg):
    print(f"[genes] {msg}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose gauss_tpu_torch is timed")
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)
    from gauss_tpu_torch.core import genekernels
    from gauss_tpu_torch.models.genome import GenomeEngine
    from gauss_tpu_torch.utils.benchdata import (cached_panel,
                                                 make_bench_input)

    if not torch.cuda.is_available():
        raise SystemExit("profile_genes.py needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    log(f"{smi}; package from {root}")
    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    store = cached_panel(CACHE, MAIN_SNPS, bp_span=MAIN_SNPS * 2000 // 3)
    inp = make_bench_input(store, MEASURED_FRAC)
    annot = gene_annotation(store.index, CACHE)
    engine = GenomeEngine(store, device=dev)
    log(f"panel {store.G.shape} and annotation in "
        f"{time.perf_counter() - t:.1f}s")
    pop_wgt = {p: 1.0 / store.desc.num_pops for p in store.desc.pops}
    for mode, kw in (("jepegmix", dict(pop_wgt=pop_wgt)),
                     ("jepeg", dict(study_pop=STUDY_POP))):
        pg = engine.prepare_genes(inp, annot, **kw)
        pg.jepeg_region()
        panel = pg._device_panel()
        idx, Ws, zs = pg._gene_inputs(pg._select(None, None))
        nb = len(genekernels._buckets([len(g) for g in idx],
                                      panel.shape[1], 1 << 26))
        stats_ms = cuda_ms(lambda: genekernels.gene_stats_resident(
            panel, idx, Ws, zs, pg.pop_sizes, pg.wgts,
            lam=engine.settings.lambda_), GENE_REPS)
        wall = host_wall(pg.jepeg_region, GENE_REPS) * 1e3
        prof = device_ms(pg.jepeg_region, reps=1)
        kernels = round(sum(prof.counts.values()))
        copies = None if prof.copies is None else round(prof.copies)
        kdev = sum(prof.kernels.get(k, 0.0) for k in prof.counts)
        by = lambda pre: sum(ms for k, ms in prof.kernels.items()
                             if k.startswith(pre))
        pdev, tdev = by("gene_partials_kernel"), by("gene_tail_kernel")
        top = sorted(((ms * 1e3, prof.counts.get(k), k[:60])
                      for k, ms in prof.kernels.items()), reverse=True)[:6]
        log(f"{mode}: {len(idx)} genes in {nb} buckets; gene stats on the "
            f"card {stats_ms:.3f} ms (CUDA events, median of {GENE_REPS}); "
            f"jepeg_region {wall:.3f} ms wall -> {len(idx) / wall * 1e3:.1f}"
            f" genes/s; torch.profiler over one jepeg_region: {kernels} "
            f"CUDA kernels ({kernels / nb:.1f} per bucket), {copies} copies"
            f" / sets, kernels' device time {kdev:.3f} ms (gene_partials "
            f"{pdev:.4f}, gene_stats_tail {tdev:.4f}); top (us, count, "
            f"kernel): {top}")
        print(json.dumps(dict(root=root, mode=mode, gene_stats_ms=stats_ms,
                              wall_ms=wall, genes_per_s=len(idx) / wall * 1e3,
                              buckets=nb, kernels=kernels, copies=copies,
                              kernel_device_ms=kdev, partials_device_ms=pdev,
                              tail_device_ms=tdev, card=smi)), flush=True)
        del pg, panel
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

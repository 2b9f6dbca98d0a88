"""What chip_smoke.py and profile_genes.py share: timing on a CUDA card
(CUDA events, host walls, torch.profiler's kernel records) and phase 8's
gene workload.

Importing this module imports nothing of gauss_tpu_torch, so that
profile_genes.py can time another checkout's package (its --root):
``gene_annotation`` imports the gauss_tpu_torch found first on sys.path
when it is called.
"""

import collections
import os
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

MAIN_SNPS = 64_000       # the bench workload's region length in SNPs
MEASURED_FRAC = 0.4
N_GENES, GENE_SNPS = 280, 24   # ~6.5 genes per Mb over the 43 Mb region
STUDY_POP = "CEU"        # jepeg's one population (the largest)
GENE_REPS = 5            # timed calls of phase 8's gene path
WARM_S = 0.05            # warm-up seconds before each timing
PROFILE_MARGINS = (0.02, 0.2, 1.0)   # seconds of idle capture window kept
                         # on both sides of a device_ms profile's calls,
                         # per attempt

#: device_ms's result: ms per call on the device alone (None when the
#: profiler kept no device record), {kernel: ms per call} (memory copies
#: and sets included), {kernel: launches per call} and memory copies and
#: sets per call
DeviceProfile = collections.namedtuple(
    "DeviceProfile", ["ms", "kernels", "counts", "copies"])


def log(msg):
    print(f"[timing] {msg}", flush=True)


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


def host_wall(fn, reps=3):
    """Median host seconds of fn(), each call ending in a synchronize."""
    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return statistics.median(walls)


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


def device_ms(fn, reps=50):
    """DeviceProfile of fn(): the CUDA kernels, memory copies and sets
    torch.profiler records over ``reps`` calls enqueued back to back after
    a warm-up call, their host path left out.

    A profile of well under a millisecond, taken minutes into the process,
    can come back with no kernel record at all (seen on the H100 on the
    two shortest profiles, K4 in clusters of 8 and torch._int_mm at 256 x
    2048, 0.3 ms each; the profiles of 5 ms before and after them held
    their records): the profiler keeps only records inside its capture
    window.  So the calls sit PROFILE_MARGINS[0] seconds inside the
    window on both sides, an empty profile is taken again with the next,
    wider margin, and after the last the result's ms is None and its
    dicts are empty: the number is then reported as not measured, the
    check itself does not depend on it."""
    fn()
    torch.cuda.synchronize()
    for attempt, margin in enumerate(PROFILE_MARGINS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(margin)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(margin)
        kernels, counts = {}, collections.Counter()
        copies = 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            name = short_name(e.key)
            if e.key.startswith(("Memcpy", "Memset")):
                copies += e.count
            else:
                counts[name] += e.count
            if us > 0:
                kernels[name] = kernels.get(name, 0.0) + us / 1e3 / reps
        if kernels:
            return DeviceProfile(
                sum(kernels.values()), kernels,
                {k: n / reps for k, n in counts.items()}, copies / reps)
        log(f"torch.profiler recorded no device time (profile "
            f"{attempt + 1} of {len(PROFILE_MARGINS)}, margin {margin:g} s)")
    return DeviceProfile(None, {}, {}, None)


class IndexOf:
    """What make_annotation reads of a panel: its index."""

    def __init__(self, index):
        self.index_df = index


def gene_annotation(index, cache):
    """Phase 8's gene annotation over a panel's SNP ``index``: up to
    N_GENES genes of GENE_SNPS SNPs (make_annotation), written under
    ``cache`` and read back with the package's reader."""
    from gauss_tpu_torch.io import readers
    from gauss_tpu_torch.utils.testing import make_annotation

    path = os.path.join(cache, f"annot_{len(index)}.txt")
    os.makedirs(cache, exist_ok=True)
    make_annotation(IndexOf(index), path,
                    n_genes=min(N_GENES, len(index) // (GENE_SNPS + 1)),
                    snps_per_gene=GENE_SNPS)
    return readers.read_annotation(path)

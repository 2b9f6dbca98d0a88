#!/usr/bin/env python
"""Where cholesky_solve's time goes on one CUDA card: the tree's kernel
beside variants of csrc/chol_solve.cu built from it by text edits, timed
in turns at the main path's widths.

    python3 profile_solve.py [--reps N]

Variants (each edit must match the source, or the script stops):

- ``tree``: the kernel as it is; ``tree:tf32``: the same kernel under the
  TF32 switch (one product a tile product instead of three);
- ``phases``: the tree's kernel with clock64 counters per phase of a task
  (the task fetch, the input tile's loads, the products, the staging and
  the wait for L_jj, the in-tile step, the stores and the release; the
  producer's waits for the tiles a chunk needs and for free stages),
  summed over blocks and printed per block after one call;
- ``one_box``: every TMA load reads one L2-resident box (the same count
  and size of loads, no L2 traffic to speak of);
- ``carveout``: the most shared memory carved out of the SM's L1;
- ``no_products``, ``no_split``, ``no_substitution``: the wgmmas, the
  split into hi and lo, or the panels' and solves' in-tile substitution
  left out.

The variants that change the arithmetic (``one_box``, ``no_*``) give
wrong results; they also run with the failure exit of the in-tile
factorization taken out, so that garbage pivots do not end a window's
work early and each variant times the full task graph.  Their error
against the library pair is printed beside the time.

Inputs: bench_kernels.solve_blocks (the main path's widths, Mp = 1280,
K = 961, at W = 43, 7 and 1).  Each variant is compiled by nvcc with the
package's flags into its own library under gauss_tpu_torch/_build/ and
called through ctypes with a fresh copy of its inputs (the kernel solves
in place); times are CUDA events, median of --reps, in turns (the list
forwards, then backwards).
"""

import argparse
import ctypes
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from bench_kernels import solve_blocks                          # noqa: E402
from chip_smoke import (cuda_ms_fresh, log, normwise,           # noqa: E402
                        phase_device, solve_bounds)
from gauss_tpu_torch.core.stats import full_f32_matmul          # noqa: E402
from gauss_tpu_torch.ops import _build                          # noqa: E402

SRC = os.path.join(_build.SRC_DIR, "chol_solve.cu")
OUT = os.path.join(_build.BUILD_DIR, "profile_solve")
PHASES = ("fetch", "input", "products", "stage", "in-tile", "store",
          "producer: tile waits", "producer: stage waits")

NO_FAIL = [("      if (!(d > 0.0f)) return q + 1;\n", "")]
END = "    fence_proxy_async();                // the next TMA loads land"
LEFT_SOLVE = "      left_solve(D, Ls, rq, xs);"
LOADS = ("          tma_load_3d(st, &mapL, &full[s], c * kKc, j * kT, w);\n"
         "          if (k.kind == 1)\n"
         "            tma_load_3d(st + kBox, &mapL, &full[s], c * kKc, i * kT,"
         " w);\n"
         "          else if (k.kind == 2)\n"
         "            tma_load_3d(st + kBox, &mapY, &full[s], c * kKc,"
         " k.x * kT, w);\n")
SMEM = "cudaFuncAttributeMaxDynamicSharedMemorySize,\n      kSmem);\n"
SAVE = ("  if (threadIdx.x == {t})\n    for (int q = {a}; q < {b}; ++q)\n"
        "      atomicAdd(&g_phases[q], (unsigned long long)acc[q]);\n")
MARKS = [
    ("  uint32_t gc = 0;",
     "  long long acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  long long last = clock64();\n"
     "#define MARK(q) do { const long long now_ = clock64();"
     " acc[q] += now_ - last; last = now_; } while (0)\n"
     "  uint32_t gc = 0;"),
    ("    if (t >= total) break;\n",
     "    if (t >= total) break;\n    MARK(0);\n"),
    ("    // One 64-k block an iteration",
     "    MARK(1);\n    // One 64-k block an iteration"),
    ("    for (int e = 0; e < 32; ++e) P[e] -= C[e];",
     "    for (int e = 0; e < 32; ++e) P[e] -= C[e];\n    MARK(2);"),
    ("    Tile D;\n", "    MARK(3);\n    Tile D;\n"),
    (LEFT_SOLVE, LEFT_SOLVE + " MARK(4);"),
    (END + " here\n  }\n}\n",
     "    MARK(5);\n" + END + " here\n  }\n"
     + SAVE.format(t=0, a=0, b=6) + SAVE.format(t=128, a=6, b=8) + "}\n"),
    ("            if (seen_a <= kb)",
     "            const long long w0 = clock64();\n"
     "            if (seen_a <= kb)"),
    ("            fence_proxy_async_global();\n",
     "            acc[6] += clock64() - w0;\n"
     "            fence_proxy_async_global();\n"),
    ("          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);\n",
     "          const long long w1 = clock64();\n"
     "          if (round > 0) mbar_wait(&empty[s], (round - 1) & 1);\n"
     "          acc[7] += clock64() - w1;\n"),
    ("template <bool kX3>\n__global__ void __launch_bounds__",
     "__device__ unsigned long long g_phases[8];\n\n"
     "template <bool kX3>\n__global__ void __launch_bounds__"),
    ('extern "C" int gauss_chol_solve_smem(',
     'extern "C" int gauss_chol_solve_phases(unsigned long long* out) {\n'
     "  cudaError_t e = cudaMemcpyFromSymbol(out, g_phases, 64);\n"
     "  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_phases, zero, 64);\n"
     "  return (int)e;\n}\n\n"
     'extern "C" int gauss_chol_solve_smem('),
]
VARIANTS = {
    "tree": [],
    "phases": MARKS,
    "one_box": NO_FAIL + [
        (LOADS, "          tma_load_3d(st, &mapL, &full[s], 0, 0, 0);\n"
                "          if (!same)\n"
                "            tma_load_3d(st + kBox, &mapL, &full[s], 0, 0,"
                " 0);\n")],
    "carveout": [
        (SMEM, SMEM + "  if (e == cudaSuccess)\n"
               "    e = cudaFuncSetAttribute(\n"
               "        chol_solve_kernel<kX3>,\n"
               "        cudaFuncAttributePreferredSharedMemoryCarveout,"
               " 100);\n")],
    "no_products": NO_FAIL + [
        ("        chunk_products<kX3>(Q, ah, al, smem_u32(bbox),\n"
         "                            smem_u32(st + 2 * kBox), h == 0);\n",
         "")],
    "no_split": NO_FAIL + [
        ("        split_b<kX3>(bbox, st + 2 * kBox);\n", "")],
    "no_substitution": NO_FAIL + [(LEFT_SOLVE, "      //")],
}


def build(name, edits):
    """The variant's library, built from the tree's source with ``edits``
    applied (each must match exactly once)."""
    src = open(SRC).read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: edit does not match the source: "
                               f"{old[:60]!r}")
        src = src.replace(old, new)
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "chol_solve.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(d, "libchol_solve.so")
    inc = ["-I", _build.SRC_DIR]
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *inc,
                           "-shared", "-o", so, path],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    log(f"{name}: " + "; ".join(regs))
    lib = ctypes.CDLL(so)
    P = ctypes.c_void_p
    lib.gauss_chol_solve.argtypes = [P, P, P] + [ctypes.c_int] * 5 + [P]
    lib.gauss_chol_solve_flags.argtypes = [ctypes.c_int] * 3
    return lib


def solve(lib, B11, rhs, tf32=False):
    W, Mp, K = rhs.shape
    flags = torch.zeros(lib.gauss_chol_solve_flags(W, Mp, K),
                        dtype=torch.int32, device=rhs.device)
    err = lib.gauss_chol_solve(B11.data_ptr(), rhs.data_ptr(),
                               flags.data_ptr(), W, Mp, K, 0, int(tf32),
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gauss_chol_solve: CUDA error {err}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    dev, _ = phase_device()
    libs = {name: build(name, edits) for name, edits in VARIANTS.items()}
    runs = [(n, libs[n], False) for n in libs] + [("tree:tf32", libs["tree"],
                                                   True)]
    g = torch.Generator(device=dev).manual_seed(0)
    for W in (43, 7, 1):
        B11, rhs = solve_blocks(dev, g, W)
        Bk, Rk = B11.clone(), rhs.clone()

        def fresh():
            Bk.copy_(B11)
            Rk.copy_(rhs)

        times = {n: [] for n, _, _ in runs}
        for order in (runs, runs[::-1]):
            for n, lib, tf32 in order:
                times[n].append(cuda_ms_fresh(
                    fresh, lambda: solve(lib, Bk, Rk, tf32), args.reps))
        with full_f32_matmul():
            L, _ = torch.linalg.cholesky_ex(B11)
            ref = torch.linalg.solve_triangular(L, rhs, upper=False)
        bound = solve_bounds(W, 1280, rhs.shape[2], False)[0]
        rows = []
        for n, lib, tf32 in runs:
            fresh()
            solve(lib, Bk, Rk, tf32)
            torch.cuda.synchronize()
            ms = statistics.median(times[n])
            rows.append(f"{n} {ms:.3f} ms ({bound / ms:.1%} of the 3xTF32 "
                        f"bound; normwise against the pair "
                        f"{normwise(Rk, ref):.2e})")
        log(f"W={W}: " + "; ".join(rows))
        lib = libs["phases"]
        buf = (ctypes.c_ulonglong * 8)()
        lib.gauss_chol_solve_phases(buf)
        fresh()
        solve(lib, Bk, Rk)
        torch.cuda.synchronize()
        lib.gauss_chol_solve_phases(buf)
        per_sm = ctypes.c_int(0)
        lib.gauss_chol_solve_smem(ctypes.byref(per_sm))
        blocks = per_sm.value * torch.cuda.get_device_properties(
            dev).multi_processor_count
        total = sum(buf[q] for q in range(6))
        log(f"W={W} phases, Mcycles per block (of {blocks}): "
            + ", ".join(f"{PHASES[q]} {buf[q] / blocks / 1e6:.3f}"
                        + (f" ({buf[q] / total:.1%})" if q < 6 else "")
                        for q in range(8)))
        del B11, rhs, Bk, Rk, L, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

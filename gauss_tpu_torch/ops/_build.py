"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per file, all started together) and the objects are linked into
one shared library with a plain C interface, loaded with ``ctypes``.  No
PyTorch header is included, so a build takes seconds.  The library lives
in ``gauss_tpu_torch/_build/`` under a name keyed by a hash of the sources,
the headers they share (``csrc/*.cuh``) and the flags: an unchanged tree
loads the existing build.  A failed build raises with nvcc's output;
nothing falls back to the plain versions.

Nothing here runs at import time: ``library()`` builds on first use.
The wrappers take the library for a launch from ``kernel_library`` and
pass pointers (``ptr``) and the current stream (``stream``) to it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIB: Optional[ctypes.CDLL] = None
#: seconds the last ``library()`` call spent compiling (0.0 on a cache hit)
build_seconds = 0.0
#: nvcc's output of that build: ptxas registers / shared memory per kernel
build_log = ""

_P = ctypes.c_void_p
_SIGNATURES = {
    # (G, idx, order, out, n, S, R, stream)
    "gauss_gather_rows": [_P, _P, _P, _P, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_longlong, _P],
    # (X, Y, x0, y0, out, W, nx, ny, S, RX, RY, nseg, ends, beta, sym,
    #  stream)
    "gauss_weighted_gram_t1": [_P, _P, _P, _P, _P, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                               ctypes.c_longlong, ctypes.c_longlong,
                               ctypes.c_int, _P, _P, ctypes.c_int, _P],
    "gauss_weighted_gram_smem": [],
    # probes/probe7_int4: (x, out, R, K, Kb, stream)
    "gauss_pack_int4": [_P, _P, ctypes.c_longlong, ctypes.c_longlong,
                        ctypes.c_longlong, _P],
    # (A, B, C, M, N, Kb, stream)
    "gauss_int4_dot": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, _P],
    # (row_bytes, rows_per_cta)
    "gauss_resident_rowsum_smem": [ctypes.c_int, ctypes.c_int],
    # (row_bytes, rows_per_cta, cluster, *smem_optin, *clusters)
    "gauss_resident_rowsum_fit": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_int)],
    # (x, out, R, row_bytes, int4, cluster, stream)
    "gauss_resident_rowsum": [_P, _P, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, _P],
    # region_tail: (P, pooled)
    "gauss_region_pack_floats": [ctypes.c_int, ctypes.c_int],
    # (P, pooled, sym, *stages)
    "gauss_region_tail_smem": [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_int)],
    # (P, pooled, sym)
    "gauss_region_tail_groups": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
    # (T1, S, Mu, t0, R, mask, alpha, wts, P, B, Mp, diag, pooled, tf32,
    #  std_out, mi_out, pack, out, stream)
    "gauss_region_corr_mm": [_P, _P, _P, _P, ctypes.c_longlong, _P, _P, _P,
                             ctypes.c_int, ctypes.c_int, ctypes.c_int,
                             ctypes.c_float, ctypes.c_int, ctypes.c_int,
                             _P, _P, _P, _P, _P],
    # (T1, Su, Muu, Vu, u0, Ru, Sm, Mum, m0, Rm, std_m, mi_m, u_mask,
    #  m_mask, z1, alpha, wts, P, B, Mp, Up, pooled, tf32, scratch, out,
    #  stream)
    "gauss_region_corr_um_rhs": [_P, _P, _P, _P, _P, ctypes.c_longlong, _P,
                                 _P, _P, ctypes.c_longlong, _P, _P, _P, _P,
                                 _P, _P, _P, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, _P, _P, _P],
    # (Y, sw, su, bad, B, Mp, Up, tf32, out, stream)
    "gauss_region_finalize": [_P, ctypes.c_longlong, ctypes.c_longlong, _P,
                              ctypes.c_int, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, _P, _P],
    # chol_solve: (A, Y, flags, W, Mp, K, want_l, tf32, stream)
    "gauss_chol_solve": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
    # (W, Mp, K): int32 entries of the flags buffer
    "gauss_chol_solve_flags": [ctypes.c_int, ctypes.c_int, ctypes.c_int],
    # (*blocks_per_sm)
    "gauss_chol_solve_smem": [ctypes.POINTER(ctypes.c_int)],
    # gene_stats: (X, S, B, n, P, *bounds, groups, *group, warps, C, Ssum,
    #  Q, stream)
    "gauss_gene_partials": [_P, ctypes.c_longlong, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int,
                            ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                            ctypes.POINTER(ctypes.c_int), ctypes.c_int, _P,
                            _P, _P, _P],
    # (C, S, Q, P, B, n, pooled, *consts, npool, ridge, ids, Wz, out0,
    #  out1, out2, scratch, tickets, genes, stages, stats, stream)
    "gauss_gene_tail": [_P, _P, _P, ctypes.c_int, ctypes.c_int,
                        ctypes.c_int, ctypes.c_int,
                        ctypes.POINTER(ctypes.c_double), ctypes.c_double,
                        ctypes.c_double, _P, _P, _P, _P, _P, _P, _P,
                        ctypes.c_int, ctypes.c_int, ctypes.c_int, _P],
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "of gauss_tpu_torch are built from source on first "
                       "use")


def _sources(src_dir=SRC_DIR):
    srcs = sorted(glob.glob(os.path.join(src_dir, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {src_dir}")
    return srcs


def _headers(src_dir=SRC_DIR):
    return sorted(glob.glob(os.path.join(src_dir, "*.cuh")))


def compile_library(srcs, so: str) -> str:
    """Compile ``srcs`` into the shared library ``so``: one ``nvcc -c`` per
    source, all running at once, then one link.  Returns nvcc's output
    (ptxas's registers and shared memory per kernel); raises on failure."""
    procs = []
    for s in srcs:
        obj = f"{so}.{os.path.basename(s)}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", obj, s]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = None
    for cmd, _, p in procs:
        out = p.communicate()[0]
        log.append(out)
        if p.returncode != 0 and failed is None:
            failed = "nvcc failed (exit %d): %s\n%s" % (
                p.returncode, " ".join(cmd), out)
    objs = [obj for _, obj, _ in procs]
    try:
        if failed:
            raise RuntimeError(failed)
        cmd = [_nvcc(), "-shared", "-o", so, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed (exit %d): %s\n%s\n%s" % (
                proc.returncode, " ".join(cmd), proc.stdout, proc.stderr))
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if its build is missing."""
    global _LIB, build_seconds, build_log
    if _LIB is not None:
        return _LIB
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + _headers():
        with open(s, "rb") as fh:
            h.update(os.path.basename(s).encode() + b"\0" + fh.read())
    so = os.path.join(BUILD_DIR, f"libgauss_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        log = compile_library(srcs, tmp)
        os.replace(tmp, so)    # atomic: a concurrent loader sees all or none
        build_seconds = time.perf_counter() - t0
        build_log = log
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.gauss_cuda_error_string.argtypes = [ctypes.c_int]
    lib.gauss_cuda_error_string.restype = ctypes.c_char_p
    _LIB = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        msg = library().gauss_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def kernel_library(name: str, dev: torch.device, tensors) -> ctypes.CDLL:
    """The kernel library for a launch on ``dev``: a CUDA device, dense
    inputs (None entries skipped).  Anything else raises; nothing falls
    back."""
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    lib = library()
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous inputs")
    return lib


def ptr(t: Optional[torch.Tensor]) -> int:
    """A tensor's device address; 0 for None."""
    return 0 if t is None else t.data_ptr()


def stream(dev: torch.device) -> int:
    """The handle of ``dev``'s current CUDA stream."""
    return torch.cuda.current_stream(dev).cuda_stream

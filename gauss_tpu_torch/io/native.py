"""ctypes bindings for the native (C++) panel decoder.

The decoder (``gauss_tpu_torch/csrc/panel_decoder.cpp``: parallel BGZF
block inflation and row parsing in place of the reference's
single-threaded bgzf.c) is compiled with ``g++`` on first use into
``gauss_tpu_torch/_build/``, under a name keyed by a hash of the source
and flags: an unchanged tree loads the existing build.

``get_lib(required=True)`` raises with the compiler's output when the
build fails; ``available()`` (what ``PanelReader(use_native=None)``
asks) prints that failure once as a warning and lets the pure-Python
BGZF reader serve.  Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "csrc", "panel_decoder.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
LIBS = ["-lz", "-lpthread"]

_LIB = None
_ERROR: Optional[str] = None       # the failed build's message, once known


def build() -> str:
    """Path of the compiled decoder, compiling it first if missing.
    Raises RuntimeError with the compiler's output on failure."""
    with open(SRC, "rb") as fh:
        src = fh.read()
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode() + b"\0" + src)
    so = os.path.join(BUILD_DIR, f"libgauss_panel_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = ["g++", *CXX_FLAGS, SRC, "-o", tmp, *LIBS]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:       # no compiler on this machine
            raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError("g++ failed (exit %d): %s\n%s\n%s" % (
                proc.returncode, " ".join(cmd), proc.stdout, proc.stderr))
        os.replace(tmp, so)    # atomic: a concurrent loader sees all or none
    return so


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.gauss_bgzf_open.restype = ctypes.c_void_p
    lib.gauss_bgzf_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.gauss_bgzf_close.argtypes = [ctypes.c_void_p]
    lib.gauss_bgzf_size.restype = ctypes.c_int64
    lib.gauss_bgzf_size.argtypes = [ctypes.c_void_p]
    lib.gauss_bgzf_read_all.restype = ctypes.c_int
    lib.gauss_bgzf_read_all.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.gauss_decode_rows.restype = ctypes.c_int
    lib.gauss_decode_rows.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.gauss_last_error.restype = ctypes.c_char_p
    return lib


def get_lib(required: bool = False):
    """The loaded decoder, built first if needed.  On a failed build:
    raise (required) or warn once and return None."""
    global _LIB, _ERROR
    if _LIB is None and _ERROR is None:
        try:
            _LIB = _load(build())
        except (RuntimeError, OSError) as e:
            _ERROR = str(e)
            if not required:
                warnings.warn("native panel decoder unavailable, the "
                              f"pure-Python BGZF reader serves: {e}",
                              RuntimeWarning, stacklevel=2)
    if _LIB is None and required:
        raise RuntimeError(f"native panel decoder: {_ERROR}")
    return _LIB


def available() -> bool:
    return get_lib() is not None


class NativeBgzf:
    """Handle over a fully-inflated BGZF file (native decoder)."""

    def __init__(self, path: str, n_threads: int = 0):
        lib = get_lib(required=True)
        self._lib = lib
        self._h = lib.gauss_bgzf_open(path.encode(), n_threads)
        if not self._h:
            raise IOError(
                f"native bgzf open failed for {path}: "
                f"{lib.gauss_last_error().decode()}")

    def read_all(self) -> bytes:
        n = self._lib.gauss_bgzf_size(self._h)
        buf = np.empty(n, dtype=np.uint8)
        rc = self._lib.gauss_bgzf_read_all(
            self._h, buf.ctypes.data_as(ctypes.c_void_p), n)
        if rc != 0:
            raise IOError("native bgzf read_all failed")
        return buf.tobytes()

    def decode_rows(self, fpos: Sequence[int], pop_sizes: Sequence[int],
                    sel: Sequence[int], want_genotypes: bool = True,
                    want_af: bool = True, n_threads: int = 0
                    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        fpos = np.ascontiguousarray(fpos, dtype=np.int64)
        sizes = np.ascontiguousarray(pop_sizes, dtype=np.int64)
        sel = np.ascontiguousarray(sel, dtype=np.int64)
        n = len(fpos)
        P = len(sizes)
        width = int(sizes[sel].sum())
        G = np.empty((n, width), dtype=np.int8) if want_genotypes else None
        af = np.empty((n, P), dtype=np.float64) if want_af else None
        rc = self._lib.gauss_decode_rows(
            self._h,
            fpos.ctypes.data_as(ctypes.c_void_p), n,
            sizes.ctypes.data_as(ctypes.c_void_p), P,
            sel.ctypes.data_as(ctypes.c_void_p), len(sel),
            G.ctypes.data_as(ctypes.c_void_p) if G is not None else None,
            af.ctypes.data_as(ctypes.c_void_p) if af is not None else None,
            n_threads)
        if rc != 0:
            raise IOError(f"native decode_rows failed (code {rc})")
        return G, af

    def close(self):
        if self._h:
            self._lib.gauss_bgzf_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

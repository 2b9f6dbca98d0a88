"""ctypes bindings for the native (C++) panel decoder.

Loads csrc/libgauss_panel.so when present (build with csrc/build.sh);
callers fall back to the pure-Python BGZF path otherwise.  The native
layer replaces the reference's single-threaded bgzf.c with parallel
block inflation + row parsing (see csrc/panel_decoder.cpp).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence, Tuple

import numpy as np

_LIB = None
_TRIED = False


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cands = [
        os.path.join(here, "csrc", "libgauss_panel.so"),
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "libgauss_panel.so"),
        os.environ.get("GAUSS_PANEL_LIB", ""),
    ]
    for c in cands:
        if c and os.path.exists(c):
            return c
    return None


def get_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
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
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return get_lib() is not None


class NativeBgzf:
    """Handle over a fully-inflated BGZF file (native decoder)."""

    def __init__(self, path: str, n_threads: int = 0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native panel decoder not built")
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

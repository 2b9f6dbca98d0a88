"""K1: fused per-population weighted int8 Gram, batched over windows.

The dominant term of the reference's weighted covariance (CalWgtCov,
src/util.cpp:103-124) over each window's dosage rows::

    T1[w, i, j] = sum_k beta_k * sum_{s in segment k}
                  X[x0[w] + i, s] * Y[y0[w] + j, s]
    beta_k      = w_k * m_k^2 / (m_k - 1)

X/Y hold dosages shifted by the per-row integer c = round(mean) into
[-2, 2] (``window_kernel.prepare_resident_panel``), each population's
segment of the subject axis zero-padded to ``K_CHUNK`` columns.  The
per-segment sums are exact int32; only the f32 fold rounds.

The kernel is ``csrc/gram.cu`` (replacing the Pallas TPU kernel
``gauss_tpu/ops/pallas_gram.py:weighted_gram_t1``): wgmma s8 on 128 x 128
output tiles, fed by TMA through an mbarrier ring.  ``weighted_gram_t1``
runs it for CUDA tensors and ``weighted_gram_t1_plain``, its plain
PyTorch twin, for CPU tensors only.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import _build

#: band height granularity: nx and ny must be multiples (the kernel's
#: 128-row tiles mask a partial last tile)
ROW_TILE = 64
#: subject columns per K step: population segments pad to multiples
K_CHUNK = 64
#: segments the kernel's by-value table holds
MAX_SEGS = 64
#: longest segment whose int32 sum of |x*y| <= 4 terms stays exact
MAX_SEG_COLS = 2 ** 29

#: kernel launches since the count was last set to 0 (CUDA path only)
launches = 0


def fold_factors(seg_sizes: Sequence[int], wgts: Sequence[float]
                 ) -> np.ndarray:
    """beta_k = w_k m_k^2 / (m_k - 1) in float64, rounded once to f32
    (the TPU kernel's tile_tables rounding)."""
    m = np.asarray(seg_sizes, dtype=np.float64)
    w = np.asarray(wgts, dtype=np.float64)
    return (w * m * m / (m - 1.0)).astype(np.float32)


def mirror_lower(A: torch.Tensor) -> torch.Tensor:
    """Symmetrize matrices whose strict upper triangle is unspecified
    (batched over leading dims)."""
    return torch.tril(A) + torch.tril(A, -1).transpose(-1, -2)


def _band(A: torch.Tensor, offs: torch.Tensor, n: int) -> torch.Tensor:
    """[W, n, S] row bands of A at row offsets ``offs``; rows past the end
    read as zeros, as in the kernel."""
    rows = offs.to(torch.int64)[:, None] + torch.arange(
        n, device=A.device)[None, :]
    inside = rows < A.shape[0]
    band = A[rows.clamp(max=A.shape[0] - 1)]
    return band * inside[..., None].to(A.dtype)


def weighted_gram_t1_plain(X: torch.Tensor, Y: torch.Tensor,
                           seg_sizes: Sequence[int],
                           seg_padded: Sequence[int],
                           wgts: Sequence[float],
                           x0: torch.Tensor, y0: torch.Tensor,
                           nx: int, ny: int, sym: bool = False
                           ) -> torch.Tensor:
    """Plain PyTorch version: per segment ``beta_k * X_k @ Y_k^T`` in
    float64, summed and cast to float32.  ``sym`` is accepted for the
    kernel's signature; the full matrix is computed."""
    beta = fold_factors(seg_sizes, wgts)
    Xb, Yb = _band(X, x0, nx), _band(Y, y0, ny)
    out = torch.zeros((Xb.shape[0], nx, ny), dtype=torch.float64,
                      device=X.device)
    lo = 0
    for k, width in enumerate(seg_padded):
        a = Xb[:, :, lo:lo + width].to(torch.float64)
        b = Yb[:, :, lo:lo + width].to(torch.float64)
        out += float(beta[k]) * (a @ b.transpose(-1, -2))
        lo += width
    return out.to(torch.float32)


def _check(X, Y, seg_sizes, seg_padded, wgts, x0, y0, nx, ny) -> None:
    if X.dtype != torch.int8 or Y.dtype != torch.int8:
        raise TypeError(f"X, Y must be int8, got {X.dtype}, {Y.dtype}")
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"X {tuple(X.shape)} and Y {tuple(Y.shape)} must "
                         f"be [rows, S] with one S")
    if x0.dtype != torch.int32 or y0.dtype != torch.int32 \
            or x0.dim() != 1 or x0.shape != y0.shape:
        raise TypeError("x0, y0 must be int32 [W] row offsets")
    if len({X.device, Y.device, x0.device, y0.device}) != 1:
        raise ValueError("X, Y, x0, y0 must share one device")
    if not (len(seg_sizes) == len(seg_padded) == len(wgts) >= 1):
        raise ValueError("seg_sizes, seg_padded and wgts differ in length")
    if sum(int(p) for p in seg_padded) != X.shape[1]:
        raise ValueError(f"segments cover {sum(seg_padded)} columns, "
                         f"the subject axis has {X.shape[1]}")
    if max(int(p) for p in seg_padded) >= MAX_SEG_COLS:
        raise ValueError("a segment this long overflows the exact int32 "
                         "per-segment sum")
    if nx % ROW_TILE or ny % ROW_TILE:
        raise ValueError(f"nx={nx}, ny={ny} must be multiples of "
                         f"{ROW_TILE}")


def weighted_gram_t1(X: torch.Tensor, Y: torch.Tensor,
                     seg_sizes: Sequence[int], seg_padded: Sequence[int],
                     wgts: Sequence[float],
                     x0: torch.Tensor, y0: torch.Tensor,
                     nx: int, ny: int, sym: bool = False) -> torch.Tensor:
    """T1 [W, nx, ny] float32 for the row bands X[x0[w]:x0[w]+nx],
    Y[y0[w]:y0[w]+ny] of int8 X [RX, S], Y [RY, S].

    ``seg_sizes``: true subject counts; ``seg_padded``: segment widths on
    the subject axis (multiples of K_CHUNK on CUDA); ``wgts``: population
    weights.  ``sym``: the bands are the same rows of the same matrix
    (x0 == y0, nx == ny, X is Y); the strict upper triangle of each
    window's output is then left unspecified -- finish with
    ``mirror_lower``.  CPU tensors take the plain version."""
    global launches
    _check(X, Y, seg_sizes, seg_padded, wgts, x0, y0, nx, ny)
    if X.device.type == "cpu":
        return weighted_gram_t1_plain(X, Y, seg_sizes, seg_padded, wgts,
                                      x0, y0, nx, ny, sym)
    if X.device.type != "cuda":
        raise ValueError(f"weighted_gram_t1: unsupported device {X.device}")
    if sym and nx != ny:
        raise ValueError(f"sym needs nx == ny, got {nx}, {ny}")
    if len(seg_padded) > MAX_SEGS:
        raise ValueError(f"{len(seg_padded)} segments; the kernel holds "
                         f"{MAX_SEGS}")
    if any(int(p) <= 0 or int(p) % K_CHUNK for p in seg_padded):
        raise ValueError(f"segment widths {tuple(seg_padded)} must be "
                         f"positive multiples of {K_CHUNK}")
    for t in (X, Y, x0, y0):
        if not t.is_contiguous():
            raise ValueError("weighted_gram_t1 needs contiguous inputs")
    if X.data_ptr() % 16 or Y.data_ptr() % 16:
        raise ValueError("X and Y must be 16-byte aligned")
    W = x0.shape[0]
    out = torch.empty((W, nx, ny), dtype=torch.float32, device=X.device)
    if W == 0 or nx == 0 or ny == 0:
        return out
    ends = np.cumsum(np.asarray(seg_padded, dtype=np.int64)).astype(
        np.int32)
    beta = fold_factors(seg_sizes, wgts)
    lib = _build.library()
    with torch.cuda.device(X.device):
        err = lib.gauss_weighted_gram_t1(
            X.data_ptr(), Y.data_ptr(), x0.data_ptr(), y0.data_ptr(),
            out.data_ptr(), W, nx, ny, X.shape[1], X.shape[0], Y.shape[0],
            len(seg_padded), ends.ctypes.data, beta.ctypes.data, int(sym),
            torch.cuda.current_stream(X.device).cuda_stream)
    _build.check(err, "weighted_gram_t1")
    launches += 1
    return out

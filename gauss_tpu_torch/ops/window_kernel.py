"""Resident region kernel for dist/distmix imputation.

A region's windows run as one batch: two K1 launches (the mm and um
Grams, ``ops/gram.py``) over row bands of resident shifted panels, the
CalWgtCov tail in plain torch, then a Cholesky factorization and one
triangular solve per window.  The float64 host path
(``models/genome.PreparedRun.impute_window``) is the parity anchor; this
path runs in float32 and agrees with it to f32 solve noise.

Numerical formulation
---------------------
The reference's weighted covariance (CalWgtCov, src/util.cpp:103-124) is

    cov(x,y) = sum_k w_k f_k (m_k*Sxy - Sx*Sy)           f_k = m_k/(m_k-1)
             + sum_k w_k xbar_k ybar_k
             - (sum_k w_k xbar_k)(sum_k w_k ybar_k)

The first term cancels catastrophically in f32 when evaluated from raw
sums.  Each dosage row is therefore shifted by the per-(row, population)
integer c = round(mean) in {0, 1, 2} once, at preparation: covariance
is shift-invariant, m*C' - S'S'^T = m*C - SS^T holds exactly in
integers, and both terms shrink to the size of the result.  The heavy
term sum_k beta_k X'_k Y'_k^T is K1's exact per-segment int32 Gram; the
rank-P correction and the mean terms are small batched matmuls.

Pooled mode (``spec.wgts is None``, the homogeneous dist estimator,
CalCor src/util.cpp:49-70) is the same path with the whole subject axis
as one segment whose fold factor is exactly 1.0f.

Masking: padded subject columns are zero and add exactly 0.  Masked
measured rows get identity rows/cols in B11 (plus the ridge) and zero
Z1 entries; masked unmeasured rows produce values the compaction drops.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import stats
from . import gram
from .gather import gather_rows

#: windows per slab of the batched tail; bounds the [B, Mp, Mp] f32
#: temporaries of very long regions
WIN_SLAB = 64


@dataclasses.dataclass(frozen=True)
class WindowKernelSpec:
    """Static configuration of a region kernel."""

    pop_sizes: Tuple[int, ...]         # TRUE per-pop subject counts
    pop_sizes_padded: Tuple[int, ...]  # per-pop padded segment widths
    wgts: Optional[Tuple[float, ...]]  # None -> unweighted (dist)
    lam: float = 0.1

    @property
    def bounds(self) -> np.ndarray:
        return stats.segment_bounds(self.pop_sizes_padded)


def pad_pop_segments(G: np.ndarray, pop_sizes: Sequence[int],
                     multiple: int = 1) -> Tuple[np.ndarray, Tuple[int, ...]]:
    """Zero-pad each population segment of the subject axis to a multiple.
    Returns (padded G, padded sizes)."""
    bounds = stats.segment_bounds(pop_sizes)
    segs, padded = [], []
    for k in range(len(pop_sizes)):
        seg = G[..., int(bounds[k]):int(bounds[k + 1])]
        m = seg.shape[-1]
        mp = -(-m // multiple) * multiple
        if mp != m:
            pad = [(0, 0)] * (seg.ndim - 1) + [(0, mp - m)]
            seg = np.pad(seg, pad)
        segs.append(seg)
        padded.append(mp)
    return np.concatenate(segs, axis=-1), tuple(padded)


def win_slab(W: int) -> int:
    """Windows per slab: all of them up to WIN_SLAB, else the smallest
    equal split into ceil(W / WIN_SLAB) slabs.  Callers pad W to a
    multiple (fewer than one padding window per slab)."""
    n = -(-W // WIN_SLAB)
    return -(-W // n)


def _gram_segments(spec: WindowKernelSpec):
    """(seg_sizes, seg_padded, weights) of K1's accumulation groups.
    Pooled: ONE segment over the whole padded axis with weight
    (n-1)/n^2, so beta = w n^2/(n-1) is 1.0f exactly after the f32
    rounding."""
    if spec.wgts is None:
        n = int(sum(spec.pop_sizes))
        return ((n,), (int(sum(spec.pop_sizes_padded)),),
                (float((n - 1.0) / (float(n) * n)),))
    return spec.pop_sizes, spec.pop_sizes_padded, spec.wgts


def _row_chunk(S: int) -> int:
    """Rows per chunk of the per-segment sums: the int32 copy that
    ``sum(dtype=torch.int32)`` makes of an int8 slice stays <= 1 GiB."""
    return max(1, 2 ** 28 // max(S, 1))


def prepare_resident_panel(G_dev: torch.Tensor, rows: torch.Tensor,
                           n_rows: Optional[int], spec: WindowKernelSpec):
    """Gather panel rows (K2), then shift them and take per-row statistics.

    rows: int32 [RN] panel row ids on G_dev's device.  Entries at
    positions >= n_rows are padding -- or, with n_rows=None, negative
    entries are (the per-window aligned layout's sentinels).  Padding rows
    come out all zero.

    Returns (X_shift int8 [RN, S], Sp f32 [RN, P], Mu f32 [RN, P],
    V f32 [RN]): dosages shifted by c = round(mean) in {0, 1, 2} per
    (row, population), shifted per-pop sums S' = S - m*c, per-pop means,
    and sum_k alpha_k (m_k Q_k - S_k^2) per row.  Every integer
    intermediate is exact int32.  Pooled mode (spec.wgts is None) uses
    one group: Sp/Mu are [RN, 1] and V is the centered sum of squares
    Q' - S'^2/n."""
    if n_rows is not None:
        rows = rows.clone()
        rows[n_rows:] = -1
    X = gather_rows(G_dev, rows)                       # [RN, S] int8
    RN, S = X.shape
    dev = X.device
    bounds = spec.bounds
    P = len(spec.pop_sizes)
    segs = [(int(bounds[k]), int(spec.pop_sizes[k])) for k in range(P)]

    # per-segment sums over the valid columns, in row chunks
    Ssum = torch.empty((RN, P), dtype=torch.int32, device=dev)
    Q = torch.empty((RN, P), dtype=torch.int32, device=dev)
    step = _row_chunk(S)
    for r0 in range(0, RN, step):
        blk = X[r0:r0 + step]
        for k, (lo, m) in enumerate(segs):
            seg = blk[:, lo:lo + m]
            Ssum[r0:r0 + step, k] = seg.sum(dim=1, dtype=torch.int32)
            Q[r0:r0 + step, k] = (seg * seg).sum(dim=1, dtype=torch.int32)

    if spec.wgts is None:
        n_i = int(sum(spec.pop_sizes))
        nf = float(n_i)
        Ssum = Ssum.sum(dim=1, keepdim=True)
        Q = Q.sum(dim=1, keepdim=True)
        c = torch.clamp(torch.round(Ssum.to(torch.float32) / nf), 0, 2
                        ).to(torch.int32)                  # [RN, 1]
        Sp = (Ssum - n_i * c).to(torch.float32)
        c8 = c.to(torch.int8)
        for lo, m in segs:           # in place: shift the valid columns
            X[:, lo:lo + m].sub_(c8)
        Mu = Ssum.to(torch.float32) / nf
        # shifted Q' = Q - 2c*S + n*c^2 (exact); V = Q' - S'^2/n
        Qp = Q - 2 * c * Ssum + (n_i * c) * c
        V = (Qp.to(torch.float32) - Sp * (Sp * (1.0 / nf)))[:, 0]
        return X, Sp, Mu, V

    m_i32 = torch.tensor(spec.pop_sizes, dtype=torch.int32, device=dev)
    mf = torch.tensor(spec.pop_sizes, dtype=torch.float32, device=dev)
    m64 = np.asarray(spec.pop_sizes, dtype=np.float64)
    w64 = np.asarray(spec.wgts, dtype=np.float64)
    alpha = torch.tensor((w64 * m64 / (m64 - 1.0)).astype(np.float32),
                         device=dev)
    c = torch.clamp(torch.round(Ssum.to(torch.float32) / mf), 0, 2
                    ).to(torch.int32)
    Sp = (Ssum - m_i32 * c).to(torch.float32)
    c8 = c.to(torch.int8)
    for k, (lo, m) in enumerate(segs):   # in place: shift the valid columns
        X[:, lo:lo + m].sub_(c8[:, k:k + 1])
    Mu = Ssum.to(torch.float32) / mf
    d = m_i32 * Q - Ssum * Ssum                            # exact int32
    V = d.to(torch.float32) @ alpha
    return X, Sp, Mu, V


def _slice_rows(A: torch.Tensor, offs: torch.Tensor, n: int) -> torch.Tensor:
    """Batched row slices A[offs[w] : offs[w] + n] -> [W, n, ...]."""
    rows = offs.to(torch.int64)[:, None] + torch.arange(n, device=A.device)
    return A[rows]


def _resident_block_builder(spec: WindowKernelSpec, Mp: int, Up: int):
    """Per-window (B11, B21) correlation blocks from resident panels.

    After preparation the measured rows live in Xm and the unmeasured
    rows in Xu (shifted int8), with per-row statistics:

      Spm/Spu [., P] f32   shifted per-pop row sums S' = S - m*c
      Mum/Muu [., P] f32   per-pop row means
      Vu      [RU]   f32   sum_k alpha_k (m_k Q_k - S_k^2) per row

    Window w is the band Xm[m_t0[w] : m_t0[w] + Mp] (and Xu's at
    u_t0[w]); the masks mark its real rows.  Returns
    blocks(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0 [W], u_t0 [W],
    m_mask [W, Mp], u_mask [W, Up]) -> (B11 [W, Mp, Mp], B21 [W, Up, Mp])
    float32.  Reference cost anchor: src/distmix.cpp:179-236."""
    pooled = spec.wgts is None
    seg_sizes, seg_padded, pw = _gram_segments(spec)
    m = np.asarray(spec.pop_sizes, dtype=np.float64)
    n = float(m.sum())
    consts = {}     # device -> (alpha, w), uploaded on a device's first call

    def weights(dev):
        # a host->device copy synchronizes with the stream: do it once,
        # not on every region call (that would stall the pipelining)
        if dev not in consts:
            w64 = np.asarray(spec.wgts, dtype=np.float64)
            consts[dev] = tuple(torch.from_numpy(a).to(dev) for a in (
                (w64 * m / (m - 1.0)).astype(np.float32),
                w64.astype(np.float32)))
        return consts[dev]

    def bmm_t(a, b):
        return torch.bmm(a, b.transpose(1, 2))

    def blocks(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0, m_mask, u_mask):
        t1_mm = gram.weighted_gram_t1(Xm, Xm, seg_sizes, seg_padded, pw,
                                      m_t0, m_t0, Mp, Mp, sym=True)
        t1_um = gram.weighted_gram_t1(Xu, Xm, seg_sizes, seg_padded, pw,
                                      u_t0, m_t0, Up, Mp)
        sxm = _slice_rows(Spm, m_t0, Mp)                 # [W, Mp, P]
        sxu = _slice_rows(Spu, u_t0, Up)
        vu_big = _slice_rows(Vu, u_t0, Up)               # [W, Up]
        if pooled:
            # cov = sum_s x'y' - S'x S'y / n  (= sum (x-xbar)(y-ybar))
            cov_mm = gram.mirror_lower(t1_mm) - bmm_t(sxm * (1.0 / n), sxm)
            cov_um = t1_um - bmm_t(sxu * (1.0 / n), sxm)
            var_m = torch.diagonal(cov_mm, dim1=1, dim2=2)
            var_u = vu_big
        else:
            alpha, w = weights(Spm.device)
            mu_m = _slice_rows(Mum, m_t0, Mp)
            mu_u = _slice_rows(Muu, u_t0, Up)
            big_mm = gram.mirror_lower(t1_mm) - bmm_t(sxm * alpha, sxm)
            big_um = t1_um - bmm_t(sxu * alpha, sxm)
            # mean-product terms + normalization (CalWgtCov tail)
            mi_m = mu_m @ w                              # [W, Mp]
            mi_u = mu_u @ w
            cov_mm = (big_mm + bmm_t(mu_m * w, mu_m)) \
                - mi_m[:, :, None] * mi_m[:, None, :]
            cov_um = (big_um + bmm_t(mu_u * w, mu_m)) \
                - mi_u[:, :, None] * mi_m[:, None, :]
            var_m = torch.diagonal(cov_mm, dim1=1, dim2=2)
            var_u = (vu_big + (mu_u * mu_u) @ w) - mi_u * mi_u
        one = torch.ones((), dtype=torch.float32, device=Xm.device)
        std_m = torch.sqrt(torch.where(m_mask > 0, var_m, one))
        std_u = torch.sqrt(torch.where(u_mask > 0, var_u, one))
        B11 = cov_mm / (std_m[:, :, None] * std_m[:, None, :])
        B21 = cov_um / (std_u[:, :, None] * std_m[:, None, :])
        B11 = B11 * (m_mask[:, :, None] * m_mask[:, None, :])
        B11.diagonal(dim1=1, dim2=2).fill_(1.0 + spec.lam)
        B21 = B21 * (u_mask[:, :, None] * m_mask[:, None, :])
        return B11, B21

    return blocks


def _impute_tail(B11: torch.Tensor, B21: torch.Tensor, z1: torch.Tensor):
    """(z, info) [W, Up] from the blocks: one Cholesky and ONE triangular
    solve on [B21^T | Z1]; info = colsum((L^-1 B21^T)^2) and
    z = (L^-1 B21^T)^T (L^-1 Z1) / sqrt(info).

    cholesky_ex does not synchronize with the host (cholesky does).  A
    window whose factorization fails (info > 0) gets NaN z and info, as
    the reference device path's Cholesky returns NaN; nothing raises."""
    Up = B21.shape[1]
    L, bad = torch.linalg.cholesky_ex(B11)
    rhs = torch.cat([B21.transpose(1, 2), z1[:, :, None]], dim=2)
    Yall = torch.linalg.solve_triangular(L, rhs, upper=False)
    Y, y1 = Yall[:, :, :Up], Yall[:, :, Up]
    z2 = torch.einsum("wmu,wm->wu", Y, y1)
    info = (Y * Y).sum(dim=1)
    z = z2 / torch.sqrt(info)
    nan = torch.full((), float("nan"), dtype=z.dtype, device=z.device)
    failed = (bad != 0)[:, None]
    return torch.where(failed, nan, z), torch.where(failed, nan, info)


def build_resident_region_kernel(spec: WindowKernelSpec, Mp: int, Up: int):
    """Resident distmix imputation over a batch of windows.

    Returns ONE stacked output, so the caller copies the region to the
    host once.  Two call forms:

      fn(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0, Z1, m_mask, u_mask)
          -> [2, W, Up]  (z, info)
      fn(..., m_mask, u_mask, wi, ci)  -> [2, N]  compacted

    The second keeps only the REAL unmeasured rows (wi/ci int64 [N]
    window/column indices).  W must be a multiple of win_slab(W); slabs
    run one after another so the [B, Mp, Mp] temporaries stay bounded."""
    blocks = _resident_block_builder(spec, Mp, Up)

    def fn(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0, Z1, m_mask, u_mask,
           wi=None, ci=None):
        W = m_t0.shape[0]
        B = win_slab(W)
        if W % B:
            raise ValueError(f"{W} windows is not a multiple of the slab "
                             f"width {B}; pad the batch")
        zs, infos = [], []
        for s in range(0, W, B):
            sl = slice(s, s + B)
            B11, B21 = blocks(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0[sl],
                              u_t0[sl], m_mask[sl], u_mask[sl])
            z, info = _impute_tail(B11, B21, Z1[sl].to(torch.float32))
            zs.append(z)
            infos.append(info)
        z, info = torch.cat(zs), torch.cat(infos)
        if wi is not None:
            return torch.stack([z[wi, ci], info[wi, ci]])
        return torch.stack([z, info])

    return fn

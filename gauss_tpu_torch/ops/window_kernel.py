"""Resident region kernels: dist/distmix imputation, computeLD and qcat.

A region's windows run as one batch over row bands of resident shifted
panels: K1 Grams (``ops/gram.py``; one per slab for LD, two for
imputation and qcat), the CalWgtCov tail (``ops/region_tail.py``'s
kernels), then per window a Cholesky factorization and one triangular
solve (imputation, qcat) or the expansion to its final float64 matrix
(LD).  The float64 host paths (``models/genome.PreparedRun.
impute_window``, ``models/dist``, ``models/ld``, ``models/qcat``) are the
parity anchors; these kernels run in float32 and agree with them to f32
noise.

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
rank-P correction, the mean terms and the normalization are one pass of
``ops/region_tail`` per block.

Pooled mode (``spec.wgts is None``, the homogeneous dist estimator,
CalCor src/util.cpp:49-70) is the same path with the whole subject axis
as one segment whose fold factor is exactly 1.0f.

Masking: padded subject columns are zero and add exactly 0.  Masked
measured rows get identity rows/cols in B11 (plus the ridge) and zero
Z1 entries; masked unmeasured rows produce values the compaction drops.

Subject shards (``parallel/mesh.py``): every statistic is a sum over
subjects, so the panel may be split into column shards, each holding an
equal slice of every population (``subject_shard_layout``).  The
preparation sums the shards' exact int32 per-(row, population) sums
before it shifts, so every shard is shifted by the same global c; K1
runs once per shard and the f32 partials of T1 are added on the first
shard's device, in shard order; everything after T1 runs there once.
One shard is the unsharded case, through the same code.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import stats
from ..core.stats import full_f32_matmul
from . import gram, region_tail
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
    min_abs_eig: float = 1e-5          # as gauss_tpu's spec; no resident
                                       # kernel reads it (ridge, no clip)
    eig_cutoff: float = 0.01           # CountPC threshold (qcat num_eig)
    # per subject shard, its valid columns per population: the first ones
    # of each of its segments (divisibility padding lands in the tail
    # shards, parallel/mesh.subject_valid_counts).  None: one shard whose
    # segments start with pop_sizes valid columns.  With shards,
    # pop_sizes stay the TRUE global counts (c, alpha, beta use them) and
    # pop_sizes_padded are each shard's local segment widths.
    shard_valid: Optional[Tuple[Tuple[int, ...], ...]] = None

    @property
    def bounds(self) -> np.ndarray:
        return stats.segment_bounds(self.pop_sizes_padded)

    @property
    def valid_counts(self) -> Tuple[Tuple[int, ...], ...]:
        """Valid columns per population, one tuple per subject shard."""
        return self.shard_valid or (tuple(self.pop_sizes),)


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


@functools.lru_cache(maxsize=16)
def _pop_consts(pop_sizes, wgts, dev):
    """(m int32, m f32, alpha f32) [P] on ``dev``: the populations' sizes
    and alpha_k = w_k m_k / (m_k - 1).  Uploaded once per (populations,
    device): a host->device copy waits for the stream, and a run prepares
    a panel per region batch."""
    m64 = np.asarray(pop_sizes, dtype=np.float64)
    w64 = np.asarray(wgts, dtype=np.float64)
    return (torch.tensor(pop_sizes, dtype=torch.int32, device=dev),
            torch.tensor(pop_sizes, dtype=torch.float32, device=dev),
            torch.tensor((w64 * m64 / (m64 - 1.0)).astype(np.float32),
                         device=dev))


def _local_sums(G_dev: torch.Tensor, rows: torch.Tensor,
                n_rows: Optional[int], spec: WindowKernelSpec,
                valid: Sequence[int]):
    """Preparation, step 1, on one subject shard: gather its panel rows
    (K2), then the exact int32 per-(row, population) sums S and Q over
    its valid columns.  Returns (X int8 [RN, S_loc], segs [(first column,
    valid count)] per population, S, Q int32 [RN, P])."""
    if n_rows is not None:
        rows = rows.clone()
        rows[n_rows:] = -1
    X = gather_rows(G_dev, rows)                       # [RN, S] int8
    RN, S = X.shape
    dev = X.device
    bounds = spec.bounds
    P = len(spec.pop_sizes)
    segs = [(int(bounds[k]), int(valid[k])) for k in range(P)]

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
    return X, segs, Ssum, Q


def prepare_sharded_panel(G_shards: Sequence[torch.Tensor],
                          rows: Sequence[torch.Tensor],
                          n_rows: Optional[int], spec: WindowKernelSpec):
    """prepare_resident_panel over subject shards: shard j's panel
    G_shards[j] and row ids rows[j] on its own device, with
    spec.valid_counts[j] valid columns per population.

    1. each shard gathers its rows (K2) and sums them (_local_sums);
    2. the int32 sums are added over the shards on the first shard's
       device, in shard order (exact);
    3. c = round(S / m) and Sp, Mu, V from the global sums, as below;
       every shard's valid columns are shifted by the same c, so its
       padding columns stay exactly zero.

    Returns (Xs, Sp, Mu, V): Xs one shifted int8 tensor per shard on its
    device, the statistics on the first shard's device."""
    if not (len(G_shards) == len(rows) == len(spec.valid_counts)):
        raise ValueError(f"{len(G_shards)} panels, {len(rows)} row vectors "
                         f"and {len(spec.valid_counts)} shards of valid "
                         f"counts")
    parts = [_local_sums(G, r, n_rows, spec, valid)
             for G, r, valid in zip(G_shards, rows, spec.valid_counts)]
    Xs = tuple(p[0] for p in parts)
    Ssum, Q = parts[0][2], parts[0][3]
    dev = Ssum.device
    for _, _, S_j, Q_j in parts[1:]:
        Ssum = Ssum + S_j.to(dev)
        Q = Q + Q_j.to(dev)

    if spec.wgts is None:
        n_i = int(sum(spec.pop_sizes))
        nf = float(n_i)
        Ssum = Ssum.sum(dim=1, keepdim=True)
        Q = Q.sum(dim=1, keepdim=True)
        c = torch.clamp(torch.round(Ssum.to(torch.float32) / nf), 0, 2
                        ).to(torch.int32)                  # [RN, 1]
        Sp = (Ssum - n_i * c).to(torch.float32)
        c8 = c.to(torch.int8)
        for X, segs, _, _ in parts:  # in place: shift the valid columns
            c8_j = c8.to(X.device)
            for lo, m in segs:
                X[:, lo:lo + m].sub_(c8_j)
        Mu = Ssum.to(torch.float32) / nf
        # shifted Q' = Q - 2c*S + n*c^2 (exact); V = Q' - S'^2/n
        Qp = Q - 2 * c * Ssum + (n_i * c) * c
        V = (Qp.to(torch.float32) - Sp * (Sp * (1.0 / nf)))[:, 0]
        return Xs, Sp, Mu, V

    m_i32, mf, alpha = _pop_consts(spec.pop_sizes, spec.wgts, dev)
    c = torch.clamp(torch.round(Ssum.to(torch.float32) / mf), 0, 2
                    ).to(torch.int32)
    Sp = (Ssum - m_i32 * c).to(torch.float32)
    c8 = c.to(torch.int8)
    for X, segs, _, _ in parts:      # in place: shift the valid columns
        c8_j = c8.to(X.device)
        for k, (lo, m) in enumerate(segs):
            X[:, lo:lo + m].sub_(c8_j[:, k:k + 1])
    Mu = Ssum.to(torch.float32) / mf
    d = m_i32 * Q - Ssum * Ssum                            # exact int32
    with full_f32_matmul():
        V = d.to(torch.float32) @ alpha
    return Xs, Sp, Mu, V


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
    Q' - S'^2/n.  The one-shard case of prepare_sharded_panel."""
    (X,), Sp, Mu, V = prepare_sharded_panel((G_dev,), (rows,), n_rows, spec)
    return X, Sp, Mu, V


class _ResidentBlocks:
    """Per-window correlation blocks from resident panels.

    After preparation the measured rows live in Xm and the unmeasured
    rows in Xu (shifted int8), with per-row statistics:

      Spm/Spu [., P] f32   shifted per-pop row sums S' = S - m*c
      Mum/Muu [., P] f32   per-pop row means
      Vu      [RU]   f32   sum_k alpha_k (m_k Q_k - S_k^2) per row

    Window w is the band Xm[m_t0[w] : m_t0[w] + Mp] (and Xu's at
    u_t0[w]); the masks mark its real rows.  Xm and Xu may instead be
    tuples of subject shards (prepare_sharded_panel's), each on its own
    device: T1 is then the sum of one K1 launch per shard, on the
    statistics' device (``_t1``).  ``mm`` gives the measured
    block alone (one K1 launch, the LD kernel's whole Gram); calling the
    object gives (B11 [W, Mp, Mp], rhs [W, Mp, Up + 1]) float32 with two
    K1 launches, B11's diagonal at 1 + lambda and rhs = [B21^T | Z1], the
    triangular solve's right-hand side.  The CalWgtCov arithmetic after
    K1 is ``ops/region_tail``'s.  Reference cost anchor:
    src/distmix.cpp:179-236."""

    def __init__(self, spec: WindowKernelSpec, Mp: int, Up: int = 0):
        self.spec, self.Mp, self.Up = spec, Mp, Up
        self.pooled = spec.wgts is None
        self.segs = _gram_segments(spec)
        self.m = np.asarray(spec.pop_sizes, dtype=np.float64)
        self.n = float(self.m.sum())
        self._consts = {}   # device -> (alpha, w), uploaded on first use

    def weights(self, dev):
        """(alpha [P], w [P]) f32 on ``dev``: alpha_k = w_k m_k / (m_k - 1)
        and the weights; pooled, ([1 / n], None)."""
        # a host->device copy synchronizes with the stream: do it once per
        # device, not on every region call (that would stall pipelining)
        if dev not in self._consts:
            if self.pooled:
                self._consts[dev] = (torch.tensor(
                    [1.0 / self.n], dtype=torch.float32).to(dev), None)
            else:
                w64 = np.asarray(self.spec.wgts, dtype=np.float64)
                self._consts[dev] = tuple(
                    torch.from_numpy(a).to(dev) for a in (
                        (w64 * self.m / (self.m - 1.0)).astype(np.float32),
                        w64.astype(np.float32)))
        return self._consts[dev]

    def _t1(self, X, Y, x0, y0, nx: int, ny: int, sym: bool = False):
        """K1's T1 of the bands; with shards (tuples X, Y), one launch per
        shard on the shard's device with the global fold factors and the
        local segment widths, the f32 partials added on x0's device in
        shard order -- one f32 reduction, as gauss_tpu's single psum."""
        if isinstance(X, torch.Tensor):
            return gram.weighted_gram_t1(X, Y, *self.segs, x0, y0, nx, ny,
                                         sym=sym)
        out = None
        for Xj, Yj in zip(X, Y):
            d = Xj.device
            t = gram.weighted_gram_t1(Xj, Yj, *self.segs, x0.to(d),
                                      y0.to(d), nx, ny, sym=sym)
            out = t if out is None else out + t.to(x0.device)
        return out

    def mm(self, Xm, Spm, Mum, m_t0, m_mask, diag: float):
        """(B11 [W, Mp, Mp], std_m, mi_m): masked rows/cols zero, the
        diagonal set to ``diag``; std_m and mi_m feed the um block."""
        t1_mm = self._t1(Xm, Xm, m_t0, m_t0, self.Mp, self.Mp, sym=True)
        return region_tail.corr_mm(t1_mm, Spm, Mum, m_t0, m_mask,
                                   *self.weights(Spm.device), diag)

    def __call__(self, Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0, z1,
                 m_mask, u_mask):
        B11, std_m, mi_m = self.mm(Xm, Spm, Mum, m_t0, m_mask,
                                   1.0 + self.spec.lam)
        t1_um = self._t1(Xu, Xm, u_t0, m_t0, self.Up, self.Mp)
        rhs = region_tail.corr_um_rhs(
            t1_um, Spu, Muu, Vu, u_t0, Spm, Mum, m_t0, std_m, mi_m, u_mask,
            m_mask, z1, *self.weights(Spm.device))
        return B11, rhs


def _by_slab(W: int, step, dim: int = 0) -> torch.Tensor:
    """step(slice) over equal slabs of the W windows, one after another so
    the [B, Mp, Mp] temporaries stay bounded; outputs concatenated along
    ``dim``.  W must be a multiple of win_slab(W)."""
    B = win_slab(W)
    if W % B:
        raise ValueError(f"{W} windows is not a multiple of the slab "
                         f"width {B}; pad the batch")
    return torch.cat([step(slice(s, s + B)) for s in range(0, W, B)],
                     dim=dim)


def _impute_tail(B11: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """[2, W, Up] (z, info) from the blocks: one Cholesky and ONE
    triangular solve on rhs = [B21^T | Z1] (region_tail's cholesky_solve,
    in place of both on the card); info = colsum((L^-1 B21^T)^2) and z =
    (L^-1 B21^T)^T (L^-1 Z1) / sqrt(info) (region_tail's impute_finalize).

    Nothing synchronizes with the host.  A window whose factorization
    fails (info > 0) gets NaN z and info, as the reference device path's
    Cholesky returns NaN; nothing raises."""
    Yall, _, bad = region_tail.cholesky_solve(B11, rhs)
    return region_tail.impute_finalize(Yall, bad)


def build_resident_region_kernel(spec: WindowKernelSpec, Mp: int, Up: int):
    """Resident distmix imputation over a batch of windows.

    Returns ONE stacked output, so the caller copies the region to the
    host once.  Two call forms:

      fn(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0, Z1, m_mask, u_mask)
          -> [2, W, Up]  (z, info)
      fn(..., m_mask, u_mask, wi, ci)  -> [2, N]  compacted

    The second keeps only the REAL unmeasured rows (wi/ci int64 [N]
    window/column indices).  W must be a multiple of win_slab(W)."""
    blocks = _ResidentBlocks(spec, Mp, Up)

    def fn(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0, Z1, m_mask, u_mask,
           wi=None, ci=None):
        def step(sl):
            return _impute_tail(*blocks(
                Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0[sl], u_t0[sl],
                Z1[sl].to(torch.float32), m_mask[sl], u_mask[sl]))
        with full_f32_matmul():
            out = _by_slab(m_t0.shape[0], step, dim=1)   # [2, W, Up]
        if wi is not None:
            return out[:, wi, ci]
        return out

    return fn


# -- LD: computeLD over the resident measured panel ---------------------------

LD_I16_SCALE = 32767.0
#: quantization bound of the int16 fetches: 0.5/32767 from the
#: round-to-int plus the f32 rounding of corr*32767 (|corr| <= 1, so that
#: product rounds within 32767 * 2^-24 < 0.002 units)
LD_I16_MAX_ERR = 0.502 / LD_I16_SCALE
#: int16 NaN sentinel (outside the [-32767, 32767] clip range): the
#: NaN-propagation contract for zero-variance SNPs (README deviations)
#: survives quantized fetches
LD_I16_NAN = -32768
#: LD value forms (``fetch``): the f32 correlations, or their int16 grid
#: ("i16tri" and "i16full" give the same values; gauss_tpu fetches them
#: as packed int16 lower triangles and as full int16 matrices)
LD_FETCH = ("f32", "i16tri", "i16full")


def _quant_i16(corr: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> int16 fixed point round(corr * 32767) (half to even),
    NaN -> LD_I16_NAN; on corr's device."""
    q = torch.clamp(torch.round(corr * LD_I16_SCALE), -LD_I16_SCALE,
                    LD_I16_SCALE)
    nan = torch.full((), float(LD_I16_NAN), dtype=q.dtype, device=q.device)
    return torch.where(torch.isnan(corr), nan, q).to(torch.int16)


def _dequant_i16(raw_i16: np.ndarray) -> np.ndarray:
    """Host inverse of _quant_i16 (float64, sentinel -> NaN)."""
    out = np.asarray(raw_i16, dtype=np.float64) / LD_I16_SCALE
    out[np.asarray(raw_i16) == LD_I16_NAN] = np.nan
    return out


def pack_tri_i16(corr: torch.Tensor) -> torch.Tensor:
    """The lower triangle of symmetric [..., Mp, Mp] correlations as
    int16 fixed point, row by row: [..., Mp*(Mp+1)//2], 1/8 the bytes of
    the f32 matrix with |dr| <= LD_I16_MAX_ERR.  The diagonal stays
    exactly 1.0 (32767/32767); NaN round-trips via LD_I16_NAN."""
    Mp = corr.shape[-1]
    ti, tj = torch.tril_indices(Mp, Mp, device=corr.device)
    return _quant_i16(corr)[..., ti, tj]


def unpack_tri_i16(tri: np.ndarray, Mp: int, M: int) -> np.ndarray:
    """Host inverse of pack_tri_i16 restricted to the leading M x M block:
    float64 symmetric matrix.  Row-major packing puts that block's
    triangle first: its M*(M+1)/2 entries."""
    n = M * (M + 1) // 2
    if M > Mp or len(tri) != Mp * (Mp + 1) // 2:
        raise ValueError(f"{len(tri)} packed entries is not the triangle "
                         f"of {Mp} rows, or M={M} > {Mp}")
    ti, tj = np.tril_indices(M)
    out = np.zeros((M, M))
    out[ti, tj] = _dequant_i16(np.asarray(tri)[:n])
    out = out + out.T
    out[np.diag_indices(M)] /= 2.0
    return out


def _ld_corr_fn(spec: WindowKernelSpec, Mp: int):
    """fn(Xm, Spm, Mum, m_t0, m_mask) -> [B, Mp, Mp] f32 correlations of
    one slab of windows (src/computeLD.cpp:104-116: weighted
    correlations of each window's measured SNPs, unit diagonal, no
    ridge, masked rows and columns zero): the measured half of the
    impute blocks (_ResidentBlocks.mm), one K1 launch (sym).  Window w's
    band starts at its first measured row, so its matrix is the leading
    block of its output."""
    if spec.wgts is None:
        raise ValueError("resident LD requires population weights")
    blocks = _ResidentBlocks(spec, Mp)
    return lambda Xm, Spm, Mum, m_t0, m_mask: blocks.mm(
        Xm, Spm, Mum, m_t0, m_mask, 1.0)[0]


def build_resident_ld_corr(spec: WindowKernelSpec, Mp: int):
    """Resident computeLD's f32 correlations over a batch of windows:
    fn(Xm, Spm, Mum, m_t0 [W], m_mask [W, Mp]) -> [W, Mp, Mp] f32, one
    K1 launch per slab (_ld_corr_fn).  W must be a multiple of
    win_slab(W)."""
    corr = _ld_corr_fn(spec, Mp)

    def fn(Xm, Spm, Mum, m_t0, m_mask):
        with full_f32_matmul():
            return _by_slab(m_t0.shape[0], lambda sl: corr(
                Xm, Spm, Mum, m_t0[sl], m_mask[sl]))

    return fn


@functools.lru_cache(maxsize=None)
def _dequant_table(dev: torch.device) -> torch.Tensor:
    """_dequant_i16 of every int16 value q, at q + 32768, on ``dev``: the
    host's float64 division by 32767, which torch does not reproduce on
    a card (there it divides by a host scalar as a product with its
    reciprocal, an ulp off for 896 of the 65,536 values)."""
    q = np.arange(-32768, 32768).astype(np.int16)
    return torch.from_numpy(_dequant_i16(q)).to(dev)


def expand_ld(corr: torch.Tensor, sizes, fetch: str) -> torch.Tensor:
    """The final float64 LD matrices of windows, on corr's device.

    corr [W, Mp, Mp] f32 holds window w's correlations in its leading
    sizes[w] x sizes[w] block.  Returns one flat float64 tensor with
    each window's M x M matrix in row-major order, window after window;
    a window of size 0 (padding) takes no room.  The values are the
    host formulas': "f32" the f32 block cast, as astype(np.float64);
    "i16tri" and "i16full" the int16 grid of the mirrored lower triangle
    (_quant_i16) dequantized, as unpack_tri_i16(pack_tri_i16(corr)) and
    _dequant_i16 give them: |dr| <= LD_I16_MAX_ERR from the f32 value,
    symmetric, the diagonal exactly 1.0 and LD_I16_NAN -> NaN."""
    if fetch not in LD_FETCH:
        raise ValueError(f"fetch must be one of {LD_FETCH}, got {fetch!r}")
    W, Mp = corr.shape[0], corr.shape[-1]
    if len(sizes) != W or not all(0 <= M <= Mp for M in sizes):
        raise ValueError(f"sizes {list(sizes)} do not fit {W} windows of "
                         f"{Mp} rows")
    f32 = fetch == "f32"
    # the i16 grid quantizes the mirrored lower triangle: the plain
    # version's f32 block is symmetric only to an ulp ((s alpha) s^T rounds
    # (i, j) and (j, i) apart), and an entry on a rounding boundary would
    # quantize apart (the kernel's block is exactly symmetric)
    src = corr if f32 else _quant_i16(gram.mirror_lower(corr))
    flat = torch.empty(sum(M * M for M in sizes),
                       dtype=torch.float64 if f32 else torch.int16,
                       device=corr.device)
    off = 0
    for w, M in enumerate(sizes):
        flat[off:off + M * M].view(M, M).copy_(src[w, :M, :M])
        off += M * M
    if f32:
        return flat
    return _dequant_table(flat.device).index_select(
        0, flat.to(torch.int32) + 32768)


def build_resident_ld_kernel(spec: WindowKernelSpec, Mp: int,
                             fetch: str = "i16tri"):
    """Resident computeLD over a batch of windows, to the final float64
    matrices on the device.

    fn(Xm, Spm, Mum, m_t0 [W], m_mask [W, Mp], sizes [W]) -> flat
    float64 [sum(sizes[w]**2)]: each slab's correlations
    (_ld_corr_fn, one K1 launch) through expand_ld in ``fetch``'s
    values, window w's matrix (sizes[w] = its measured row count, 0 for
    a padding window) row-major after those of the windows before it.
    W must be a multiple of win_slab(W)."""
    if fetch not in LD_FETCH:
        raise ValueError(f"fetch must be one of {LD_FETCH}, got {fetch!r}")
    corr = _ld_corr_fn(spec, Mp)

    def fn(Xm, Spm, Mum, m_t0, m_mask, sizes):
        with full_f32_matmul():
            return _by_slab(m_t0.shape[0], lambda sl: expand_ld(
                corr(Xm, Spm, Mum, m_t0[sl], m_mask[sl]), sizes[sl], fetch))

    return fn


# -- qcat: causality tests over the resident blocks ---------------------------

def _masked_column_corr(Zt: torch.Tensor, X: torch.Tensor,
                        mask: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of Zt [W, Mp] with each column of X
    [W, Mp, C], over the ``mask``-selected rows only (n = true row count
    per window).  The reference's CalCor on Eigen vectors
    (src/util.cpp:194-203) with padding excluded exactly."""
    Zm = Zt * mask
    Xm = X * mask[:, :, None]
    zbar = Zm.sum(dim=1, keepdim=True) / n[:, None]
    xbar = Xm.sum(dim=1) / n[:, None]                        # [W, C]
    szx = torch.bmm(Zm[:, None, :], Xm)[:, 0, :]
    szz = (Zm * Zm).sum(dim=1, keepdim=True)
    sxx = (Xm * Xm).sum(dim=1)
    cov = szx - n[:, None] * zbar * xbar
    vz = szz - n[:, None] * zbar * zbar
    vx = sxx - n[:, None] * xbar * xbar
    return cov / torch.sqrt(torch.clamp(vz * vx, min=1e-30))


def _qcat_tail(B11: torch.Tensor, rhs: torch.Tensor,
               m_mask: torch.Tensor) -> torch.Tensor:
    """[W, 2*Mp + 2*Up + 1]: (t_m, chisq_m, t_u, chisq_u, num_eig) of each
    window's measured and unmeasured SNPs (src/qcat.cpp:202-246).

    One Cholesky B11 = L L^T and one triangular solve on rhs =
    [B21^T | Z1] (region_tail's cholesky_solve, L kept) give Xu =
    L^-1 B21^T and Zt = L^-1 Z1; the decorrelated measured columns
    L^-1 B11 are L^T itself.  num_eig is the measured
    count: the reference's CountPC(B11, eig_cutoff) equals it whenever
    lambda > eig_cutoff (every eigenvalue of R + lambda*I is >= lambda),
    which the kernel's constructor enforces.  A window whose factorization
    fails gets NaN tests."""
    Up = rhs.shape[2] - 1
    n = m_mask.sum(dim=1)
    Yall, L, bad = region_tail.cholesky_solve(B11, rhs, want_l=True)
    Zt = Yall[:, :, Up]
    scale2 = torch.clamp(n - 3.0, min=0.0)[:, None]
    tests = []
    for X in (L.transpose(1, 2), Yall[:, :, :Up]):
        r = _masked_column_corr(Zt, X, m_mask, n)
        tests += [torch.sqrt(scale2) * r, scale2 * r * r]
    tests = region_tail._nan_where(bad != 0, torch.cat(tests, dim=1))
    return torch.cat([tests, n[:, None]], dim=1)


def build_resident_qcat_kernel(spec: WindowKernelSpec, Mp: int, Up: int):
    """Resident qcat / qcatmix tests over a batch of windows
    (src/qcatmix.cpp:145-286; pooled specs give qcat, src/qcat.cpp:
    134-262): impute's blocks (B11, [B21^T | Z1]), then _qcat_tail.

    fn(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0, Z1, m_mask, u_mask)
    -> [W, 2*Mp + 2*Up + 1] f32, columns t_m | chisq_m | t_u | chisq_u |
    num_eig (garbage where the masks are 0).  W must be a multiple of
    win_slab(W)."""
    if spec.lam <= spec.eig_cutoff:
        raise ValueError(
            f"device qcat requires lambda ({spec.lam}) > eig_cutoff "
            f"({spec.eig_cutoff}); use the host qcat path")
    blocks = _ResidentBlocks(spec, Mp, Up)

    def fn(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0, Z1, m_mask, u_mask):
        def step(sl):
            return _qcat_tail(*blocks(
                Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0[sl], u_t0[sl],
                Z1[sl].to(torch.float32), m_mask[sl], u_mask[sl]),
                m_mask[sl])
        with full_f32_matmul():
            return _by_slab(m_t0.shape[0], step)

    return fn

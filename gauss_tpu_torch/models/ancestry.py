"""Ancestry-proportion estimation: afmix, cpw2, the prep_zmix family and
zmix, in float64 on the host.

* afmix    (reference: src/afmix.cpp:30-215): AF regression
* cpw2     (reference: src/cpw2.cpp:31-211): its arcsine-sqrt variant
* prep_zmix .. prep_zmix5_sup (reference: src/zmix.cpp): z*z ~ LD
  regression datasets
* zmix     (reference: R/zmix.R:15-117): the simplex-constrained QP fit

Per-population correlations come from exact integer statistics with
float64 combines (``core/ldkernels``, ``core/stats``); the covariance
regressions use ``core/linalg`` in float64.  The ``*_store`` variants
read a decoded PanelStore instead of the bgzf panel and give the same
numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pandas as pd
import torch

from ..config import DEFAULT_SETTINGS, PanelFiles, Settings
from ..core import ldkernels, linalg, stats, variants
from ..io import readers
from ..io.panel import PanelReader, read_panel_index
from ..utils.qp import solve_simplex_qp
from ..utils.special import quantile_type7


# ---------------------------------------------------------------------------
# Shared loading
# ---------------------------------------------------------------------------

def _load_measured(input_df: pd.DataFrame, panel: PanelFiles
                   ) -> Tuple[pd.DataFrame, readers.PopDesc]:
    """ReadInput* and a ReadReferenceIndexAll-style join: the measured
    (type 1) rows in MapKey order."""
    desc = readers.read_pop_desc(panel.pop_desc_file)
    idx = read_panel_index(panel.index_file)
    table = variants.join_reference_index(
        input_df, idx, add_unmeasured=False, flip_af1study=True)
    measured = table[table["type"] == 1].reset_index(drop=True)
    return measured, desc


def _panel_afs(measured: pd.DataFrame, panel: PanelFiles,
               desc: readers.PopDesc) -> np.ndarray:
    reader = PanelReader(panel.data_file, desc)
    dec = reader.decode_rows(measured["fpos"].to_numpy(),
                             want_genotypes=False, want_af=True)
    return dec.af  # [n, P] all populations


def _panel_genotypes(measured: pd.DataFrame, panel: PanelFiles,
                     desc: readers.PopDesc) -> np.ndarray:
    reader = PanelReader(panel.data_file, desc)
    dec = reader.decode_rows(measured["fpos"].to_numpy(),
                             want_genotypes=True, want_af=False)
    return dec.G  # [n, S] all populations


# ---------------------------------------------------------------------------
# afmix / cpw2
# ---------------------------------------------------------------------------

def _afmix_weights(af_study: np.ndarray, af_panel: np.ndarray,
                   interval: int, transform: bool,
                   min_abs_eig: float) -> np.ndarray:
    """Strided-subset OLS (afmix_vec, src/afmix.cpp:114-215): for each of
    ``interval`` strided subsets, regress the study AF on the panel's
    per-population AFs through covariance blocks (Cxx^-1 Cxy, Cxx made
    positive definite) and average the coefficient vectors.  Negative
    averages become 0; positive ones are rounded half up to 3 decimals
    (src/afmix.cpp:195-202)."""
    P = af_panel.shape[1]
    mat_full = np.column_stack([af_study, af_panel]).astype(np.float64)
    if transform:
        mat_full = np.arcsin(np.sqrt(mat_full))
    W = np.zeros(P)
    for i in range(interval):
        cov = linalg.cal_cov_mat(torch.from_numpy(
            np.ascontiguousarray(mat_full[i::interval])))
        cxx = linalg.make_pos_def(cov[1:, 1:], min_abs_eig)
        W += (linalg.inv_mat(cxx) @ cov[1:, 0]).numpy() / interval
    return np.where(W < 0, 0.0, np.floor(W * 1000 + 0.5) / 1000)


def _afmix_frame(W: np.ndarray, desc: readers.PopDesc,
                 with_sup: bool) -> pd.DataFrame:
    keep = W > 0
    cols = {"sup.pop": np.asarray(desc.sup_pops, dtype=object)[keep]} \
        if with_sup else {}
    cols.update({"pop": np.asarray(desc.pops, dtype=object)[keep],
                 "wgt": W[keep]})
    return pd.DataFrame(cols)


def _afmix_percall(input_file, panel, interval, transform, settings):
    measured, desc = _load_measured(readers.read_input_af(input_file), panel)
    W = _afmix_weights(measured["af1study"].to_numpy(),
                       _panel_afs(measured, panel, desc), interval,
                       transform=transform, min_abs_eig=settings.min_abs_eig)
    return W, desc


def afmix(
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    interval: Optional[int] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> pd.DataFrame:
    """Ancestry proportions from allele frequencies (src/afmix.cpp).
    Returns rows (sup.pop, pop, wgt) with wgt > 0."""
    interval = 1000 if interval is None else int(interval)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    W, desc = _afmix_percall(input_file, panel, interval, False, settings)
    return _afmix_frame(W, desc, with_sup=True)


def cpw2(
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    interval: Optional[int] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> pd.DataFrame:
    """afmix with arcsine-sqrt variance stabilization
    (src/cpw2.cpp:147,166).  Returns rows (pop, wgt) with wgt > 0."""
    interval = 1000 if interval is None else int(interval)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    W, desc = _afmix_percall(input_file, panel, interval, True, settings)
    return _afmix_frame(W, desc, with_sup=False)


# ---------------------------------------------------------------------------
# prep_zmix family
# ---------------------------------------------------------------------------

def _pair_rows_all(z: np.ndarray, R: np.ndarray) -> np.ndarray:
    """All pairs i < j in row-major order: [zz | per-group correlations]
    (src/zmix.cpp:157-174)."""
    iu, ju = np.triu_indices(z.size, k=1)
    return np.concatenate([(z[iu] * z[ju])[:, None], R[:, iu, ju].T],
                          axis=1)


def _per_pop_pair_corr(Ga: np.ndarray, Gb: np.ndarray,
                       bounds: np.ndarray) -> np.ndarray:
    """Per-population Pearson correlation of row-paired SNPs: [n_pairs, P]
    (the per-string CalCor, src/util.cpp:153-169)."""
    P = len(bounds) - 1
    out = np.empty((Ga.shape[0], P))
    A = Ga.astype(np.float64)
    B = Gb.astype(np.float64)
    for k in range(P):
        s = slice(int(bounds[k]), int(bounds[k + 1]))
        a, b = A[:, s], B[:, s]
        m = a.shape[1]
        sx, sy = a.sum(1), b.sum(1)
        qx, qy = (a * a).sum(1), (b * b).sum(1)
        numer = m * (a * b).sum(1) - sx * sy
        den = np.sqrt(m * qx - sx * sx) * np.sqrt(m * qy - sy * sy)
        with np.errstate(invalid="ignore", divide="ignore"):
            out[:, k] = numer / den
    return out


def _load_zmix(input_file: str, panel: PanelFiles):
    return _load_measured(readers.read_input_z(input_file, all_snps=True),
                          panel)


def _af_norm_var(af_panel: np.ndarray) -> np.ndarray:
    """Normalized AF variance var / (mean (1 - mean)) with a population
    (n) denominator (cal_af_norm_var, src/zmix.cpp:1183-1219)."""
    n = af_panel.shape[1]
    mean = af_panel.mean(axis=1)
    var = (af_panel * af_panel).sum(axis=1) / n - mean * mean
    with np.errstate(invalid="ignore", divide="ignore"):
        return var / (mean * (1 - mean))


def _offset_pairs(measured, panel, desc, ii, offset, lead=None):
    """Rows (i, i + offset) for i in ii: [lead? | zz | per-pop corr]."""
    rows_a = measured.iloc[ii]
    rows_b = measured.iloc[ii + offset]
    corr = _per_pop_pair_corr(_panel_genotypes(rows_a, panel, desc),
                              _panel_genotypes(rows_b, panel, desc),
                              np.concatenate([[0], np.cumsum(desc.sizes)]))
    zz = rows_a["z"].to_numpy() * rows_b["z"].to_numpy()
    cols = ([] if lead is None else [lead.astype(np.float64)]) + [zz, corr]
    return np.column_stack(cols)


def prep_zmix(input_file: str, reference_index_file: str,
              reference_data_file: str, reference_pop_desc_file: str,
              interval: Optional[int] = None) -> np.ndarray:
    """All pairs of the strided measured-SNP subset (prep_zmix,
    src/zmix.cpp:941-1075)."""
    interval = 1 if interval is None else int(interval)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    measured, desc = _load_zmix(input_file, panel)
    sub = measured.iloc[::interval]
    G = _panel_genotypes(sub, panel, desc)
    R = ldkernels.per_pop_corr(G, tuple(int(x) for x in desc.sizes))
    return _pair_rows_all(sub["z"].to_numpy(), R)


def prep_zmix2(input_file: str, reference_index_file: str,
               reference_data_file: str, reference_pop_desc_file: str,
               interval: Optional[int] = None,
               offset: Optional[int] = None) -> np.ndarray:
    """Pairs (i, i + offset) stepping by interval over ALL measured SNPs
    (prep_zmix2, src/zmix.cpp:652-786)."""
    interval = 1000 if interval is None else int(interval)
    offset = 3 if offset is None else int(offset)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    measured, desc = _load_zmix(input_file, panel)
    ii = np.arange(0, len(measured), interval)
    return _offset_pairs(measured, panel, desc, ii[ii + offset
                                                   < len(measured)], offset)


def prep_zmix3(input_file: str, reference_index_file: str,
               reference_data_file: str, reference_pop_desc_file: str,
               interval: Optional[int] = None,
               steps: Optional[int] = None) -> np.ndarray:
    """Each strided-subset SNP paired with its next ``steps`` subset
    neighbours (prep_zmix3, src/zmix.cpp:512-633)."""
    interval = 1000 if interval is None else int(interval)
    steps = 5 if steps is None else int(steps)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    measured, desc = _load_zmix(input_file, panel)
    sub = measured.iloc[::interval].reset_index(drop=True)
    n = len(sub)
    pairs = [(i, j) for i in range(n) for j in range(i + 1,
                                                     min(i + 1 + steps, n))]
    pi = np.asarray([p[0] for p in pairs], dtype=np.int64)
    pj = np.asarray([p[1] for p in pairs], dtype=np.int64)
    G = _panel_genotypes(sub, panel, desc)
    corr = _per_pop_pair_corr(G[pi], G[pj],
                              np.concatenate([[0], np.cumsum(desc.sizes)]))
    z = sub["z"].to_numpy()
    return np.column_stack([z[pi] * z[pj], corr])


def prep_zmix4(input_file: str, reference_index_file: str,
               reference_data_file: str, reference_pop_desc_file: str,
               interval: Optional[int] = None,
               offset: Optional[int] = None) -> np.ndarray:
    """Interleaved offset pairs with a leading h-index column
    (prep_zmix4, src/zmix.cpp:364-493)."""
    interval = 1000 if interval is None else int(interval)
    offset = 3 if offset is None else int(offset)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    measured, desc = _load_zmix(input_file, panel)
    n = len(measured)
    hs, ii = [], []
    for h in range(interval):
        for i in range(h, n, interval):
            if i + offset < n:
                hs.append(h)
                ii.append(i)
    return _offset_pairs(measured, panel, desc,
                         np.asarray(ii, dtype=np.int64), offset,
                         lead=np.asarray(hs, dtype=np.int64))


def _per_pop_R_sharded(G: np.ndarray, desc: readers.PopDesc,
                       sup_level: bool, mesh) -> np.ndarray:
    """Per-group correlation matrices R[P|SP, N, N] over a (window x
    subject) device mesh: AIM rows split over the window groups, subject
    slices summed (parallel/mesh.build_sharded_pair_stats).  The partial
    statistics are exact integers, so the host float64 combine gives the
    unsharded path's matrices bit for bit at any shard count.  Super-pop
    level pools the additive per-pop statistics before combining
    (CalCorSup, src/zmix.cpp:1221-1246)."""
    from ..parallel import mesh as meshmod

    n_sub = mesh.shape["subject"]
    n_win = mesh.shape["window"]
    sizes = tuple(int(x) for x in desc.sizes)
    G_layout, _, locs = meshmod.subject_shard_layout(G, sizes, n_sub)
    N = G.shape[0]
    Np = -(-N // n_win) * n_win
    Gp = np.zeros((Np, G_layout.shape[1]), dtype=np.int8)
    Gp[:N] = G_layout
    fn = meshmod.build_sharded_pair_stats(locs, mesh)
    C, S, Q = (torch.from_numpy(a) for a in fn(Gp))
    C, S, Q = C[:, :N, :N], S[:N], Q[:N]

    if sup_level:
        groups = desc.sup_pop_indices()
        ks = [list(groups[sp]) for sp in desc.sup_pop_order()]
        ns = [float(sum(sizes[k] for k in g)) for g in ks]
        # sums of exact integers below 2^24: exact in float32
        C = torch.stack([C[g].sum(dim=0) for g in ks])
        S = torch.stack([S[:, g].sum(dim=1) for g in ks], dim=1)
        Q = torch.stack([Q[:, g].sum(dim=1) for g in ks], dim=1)
    else:
        ns = [float(s) for s in sizes]
    # CalCor combine (src/util.cpp:153-169): the unsharded path's own
    return torch.stack([
        stats.pooled_corr_combine(C[k], S[:, k], S[:, k], Q[:, k], Q[:, k], n)
        for k, n in enumerate(ns)]).numpy()


def _zmix5_mat(measured: pd.DataFrame, desc: readers.PopDesc,
               percentile: float, interval: int, sup_level: bool,
               af_fn, geno_fn, mesh=None):
    """prep_zmix5 given row-subset accessors: ``af_fn(df) -> [n, P]``
    panel AFs and ``geno_fn(df) -> [n, S]`` dosages (a bgzf decode for
    the per-call path, array slices of a PanelStore for the store
    path).  With ``mesh``, the pair correlations run over the device
    mesh (_per_pop_R_sharded)."""
    sub = measured.iloc[::interval].reset_index(drop=True)
    nv = _af_norm_var(af_fn(sub))
    aims = sub[nv > quantile_type7(nv, percentile)].reset_index(drop=True)
    G = geno_fn(aims)
    z = aims["z"].to_numpy()
    if mesh is not None:
        R = _per_pop_R_sharded(np.ascontiguousarray(G, dtype=np.int8),
                               desc, sup_level, mesh)
        return _pair_rows_all(z, R), desc
    if not sup_level:
        R = ldkernels.per_pop_corr(G, tuple(int(x) for x in desc.sizes))
        return _pair_rows_all(z, R), desc
    # super-population level: pool the member populations' subject
    # columns before the correlation (CalCorSup, src/zmix.cpp:1221-1246)
    bounds = np.concatenate([[0], np.cumsum(desc.sizes)])
    groups = desc.sup_pop_indices()
    mats = []
    for sp in desc.sup_pop_order():
        cols = np.concatenate(
            [np.arange(bounds[k], bounds[k + 1]) for k in groups[sp]])
        mats.append(ldkernels.pooled_corr(G[:, cols], G[:, cols]))
    return _pair_rows_all(z, np.stack(mats)), desc


def _prep_zmix5_core(input_file: str, panel: PanelFiles,
                     percentile: float, interval: int, sup_level: bool):
    measured, desc = _load_zmix(input_file, panel)
    return _zmix5_mat(measured, desc, percentile, interval, sup_level,
                      af_fn=lambda df: _panel_afs(df, panel, desc),
                      geno_fn=lambda df: _panel_genotypes(df, panel, desc))


def prep_zmix5(input_file: str, reference_index_file: str,
               reference_data_file: str, reference_pop_desc_file: str,
               percentile: Optional[float] = None,
               interval: Optional[int] = None) -> np.ndarray:
    """Ancestry-informative-marker selection (top AF-variance quantile),
    then all pairs (prep_zmix5, src/zmix.cpp:44-187)."""
    percentile = 0.99 if percentile is None else float(percentile)
    interval = 1 if interval is None else int(interval)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    return _prep_zmix5_core(input_file, panel, percentile, interval,
                            False)[0]


def prep_zmix5_sup(input_file: str, reference_index_file: str,
                   reference_data_file: str, reference_pop_desc_file: str,
                   percentile: Optional[float] = None,
                   interval: Optional[int] = None) -> np.ndarray:
    """prep_zmix5 at super-population resolution (prep_zmix5_sup,
    src/zmix.cpp:202-343)."""
    percentile = 0.99 if percentile is None else float(percentile)
    interval = 1 if interval is None else int(interval)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    return _prep_zmix5_core(input_file, panel, percentile, interval,
                            True)[0]


# ---------------------------------------------------------------------------
# zmix (QP fit)
# ---------------------------------------------------------------------------

def _check_level(level: str) -> None:
    if level not in ("population", "superpopulation"):
        raise ValueError("level must be 'population' or 'superpopulation'")


def zmix(input_file: str, reference_index_file: str,
         reference_data_file: str, reference_pop_desc_file: str,
         percentile: float = 0.9, interval: int = 10,
         level: str = "population") -> pd.DataFrame:
    """Z-score-based ancestry proportions (R/zmix.R:15-117): z_i z_j
    regressed on per-population LD columns under simplex constraints;
    the weights normalized, rounded to 5 decimals and normalized again,
    as the R wrapper does."""
    _check_level(level)
    panel = PanelFiles(reference_index_file, reference_data_file,
                       reference_pop_desc_file)
    mat, desc = _prep_zmix5_core(input_file, panel, percentile, interval,
                                 level == "superpopulation")
    return _zmix_fit(mat, desc, level)


def _zmix_fit(mat: np.ndarray, desc: readers.PopDesc,
              level: str) -> pd.DataFrame:
    """Simplex-QP weight fit and the normalize/round post-processing
    (R/zmix.R:48-117)."""
    mat = mat[np.isfinite(mat).all(axis=1)]
    if mat.shape[0] == 0:
        raise ValueError("zmix: no valid rows after filtering")
    y, x = mat[:, 0], mat[:, 1:]
    w = solve_simplex_qp(x.T @ x, y @ x)
    w = w / w.sum()
    w = np.round(w, 5)
    w = w / w.sum()
    if level == "superpopulation":
        return pd.DataFrame({"SuperPopulation": desc.sup_pop_order(),
                             "Weight": w})
    return pd.DataFrame({"Population": desc.pops,
                         "SuperPopulation": desc.sup_pops,
                         "Weight": w})


# ---------------------------------------------------------------------------
# PanelStore variants (decode the panel once, reuse the arrays)
# ---------------------------------------------------------------------------

def _measured_from_store(store, input_df: pd.DataFrame
                         ) -> Tuple[pd.DataFrame, np.ndarray]:
    """Join the input against the store's index (ReadReferenceIndexAll
    semantics: no unmeasured rows, af1study flipped on swaps;
    src/gauss.cpp:431-518) and map the measured rows to store rows."""
    table = variants.join_reference_index(
        input_df, store.index, add_unmeasured=False, flip_af1study=True)
    measured = table[table["type"] == 1].reset_index(drop=True)
    fmap = pd.Series(np.arange(len(store.index)),
                     index=store.index["fpos"].to_numpy())
    rows = fmap.reindex(
        measured["fpos"].to_numpy()).to_numpy().astype(np.int64)
    return measured, rows


def _afmix_store_weights(store, input_df, interval, transform, settings):
    interval = 1000 if interval is None else int(interval)
    measured, rows = _measured_from_store(store, input_df)
    return _afmix_weights(measured["af1study"].to_numpy(), store.af[rows],
                          interval, transform=transform,
                          min_abs_eig=settings.min_abs_eig)


def afmix_store(store, input_df: pd.DataFrame,
                interval: Optional[int] = None,
                settings: Settings = DEFAULT_SETTINGS) -> pd.DataFrame:
    """afmix over a decoded PanelStore: the per-subset AF matrix comes
    from store.af instead of the reference's per-SNP bgzf_seek loop
    (src/afmix.cpp:150-173, re-run on every call)."""
    W = _afmix_store_weights(store, input_df, interval, False, settings)
    return _afmix_frame(W, store.desc, with_sup=True)


def cpw2_store(store, input_df: pd.DataFrame,
               interval: Optional[int] = None,
               settings: Settings = DEFAULT_SETTINGS) -> pd.DataFrame:
    """cpw2 (arcsine-sqrt afmix) over a decoded PanelStore."""
    W = _afmix_store_weights(store, input_df, interval, True, settings)
    return _afmix_frame(W, store.desc, with_sup=False)


def _zmix5_mat_store(store, input_df: pd.DataFrame, percentile: float,
                     interval: int, sup_level: bool, mesh=None):
    measured, rows = _measured_from_store(store, input_df)
    # the store row travels as a column: _zmix5_mat resets the index when
    # it subsets, so a positional map would misalign
    measured = measured.assign(_store_row=rows)
    return _zmix5_mat(
        measured, store.desc, percentile, interval, sup_level,
        af_fn=lambda df: store.af[df["_store_row"].to_numpy()],
        geno_fn=lambda df: store.G[df["_store_row"].to_numpy()], mesh=mesh)


def prep_zmix5_store(store, input_df: pd.DataFrame,
                     percentile: Optional[float] = None,
                     interval: Optional[int] = None,
                     sup_level: bool = False, mesh=None) -> np.ndarray:
    """prep_zmix5 (or prep_zmix5_sup) over a decoded PanelStore.
    ``mesh``: run the pair correlations over a (window x subject) device
    mesh."""
    percentile = 0.99 if percentile is None else float(percentile)
    interval = 1 if interval is None else int(interval)
    return _zmix5_mat_store(store, input_df, percentile, interval,
                            sup_level, mesh=mesh)[0]


def zmix_store(store, input_df: pd.DataFrame, percentile: float = 0.9,
               interval: int = 10, level: str = "population",
               mesh=None) -> pd.DataFrame:
    """zmix over a decoded PanelStore: one decode serves the AIM
    selection (AF variance), the pair correlations and the QP fit (the
    reference re-reads the panel inside prep_zmix5 on every call,
    src/zmix.cpp:44-187).  ``mesh``: run the pair correlations over a
    (window x subject) device mesh."""
    _check_level(level)
    mat, desc = _zmix5_mat_store(store, input_df, percentile, interval,
                                 level == "superpopulation", mesh=mesh)
    return _zmix_fit(mat, desc, level)

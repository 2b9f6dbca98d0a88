"""QCAT causality tests and preparation exports, one window per call, in
float64 on the host.

* qcat     (reference: src/qcat.cpp:30-262)
* qcatmix  (reference: src/qcatmix.cpp:30-286)
* prep_qcat (reference: src/prep_qcat.cpp:29-205)
* prep_recessive_impute (reference: src/prep_qcatmix.cpp:36-303)

The per-SNP decorrelate-and-correlate loops become triangular solves:
X = L^-1 B11^T (all measured columns at once) and Y = L^-1 B21^T, then
a vectorized Pearson correlation of columns against L^-1 Z1.  The
genome engine's batched version is
``models/genome.PreparedRun.qcat_region``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd
import torch

from ..config import DEFAULT_SETTINGS, Settings
from ..core import ldkernels, linalg
from ..io import readers
from ..ops import dosage
from ..utils.special import pchisq_upper
from . import pipeline
from .dist import _load


def _column_corr_with(v: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of vector v with each column of X (CalCor on
    Eigen vectors, src/util.cpp:194-203)."""
    dv = v - v.mean()
    dX = X - X.mean(dim=0, keepdim=True)
    return (dv @ dX) / torch.sqrt((dv * dv).sum() * (dX * dX).sum(dim=0))


def _qcat_core(B11: np.ndarray, B21: np.ndarray, Z1: np.ndarray,
               pred_measured_pos: np.ndarray, settings: Settings):
    """Shared qcat math (src/qcat.cpp:202-246).

    B11 carries the ridge diagonal 1+lambda.  Returns (num_eig, dict of
    numpy t_meas, chisq_meas, t_unmeas, chisq_unmeas)."""
    B11 = torch.from_numpy(np.asarray(B11, dtype=np.float64))
    B21 = torch.from_numpy(np.asarray(B21, dtype=np.float64))
    num_eig = linalg.count_pc(B11, settings.eig_cutoff)
    L = linalg.cholesky_lower(B11)
    # the reference inverts L explicitly (InvMat on the triangular
    # factor); a triangular solve gives the same result
    z1 = torch.from_numpy(np.asarray(Z1, dtype=np.float64))
    LinvZ1 = torch.linalg.solve_triangular(L, z1[:, None], upper=False)[:, 0]

    def tests(cols: torch.Tensor):
        if not cols.shape[1]:
            return np.empty(0), np.empty(0)
        r = _column_corr_with(
            LinvZ1, torch.linalg.solve_triangular(L, cols, upper=False))
        return ((np.sqrt(num_eig - 3) * r).numpy(),
                ((num_eig - 3) * r * r).numpy())

    pos = torch.from_numpy(np.asarray(pred_measured_pos, dtype=np.int64))
    out = {}
    out["t_meas"], out["chisq_meas"] = tests(B11[pos, :].T)
    out["t_unmeas"], out["chisq_unmeas"] = tests(B21.T)
    return num_eig, out


def _qcat_assemble(win, start_bp, end_bp, af_col, m_rows, u_rows,
                   num_eig, res) -> pd.DataFrame:
    t = win.table
    n = len(t)
    qcat_m = np.zeros(n, dtype=np.int64)
    qcat_t = np.zeros(n)
    qcat_chisq = np.zeros(n)

    bp = t["bp"].to_numpy()
    pred_meas_mask = (bp[m_rows] >= start_bp) & (bp[m_rows] <= end_bp)
    pm_rows = m_rows[pred_meas_mask]
    qcat_m[pm_rows] = num_eig
    qcat_t[pm_rows] = res["t_meas"]
    qcat_chisq[pm_rows] = res["chisq_meas"]
    qcat_m[u_rows] = num_eig
    qcat_t[u_rows] = res["t_unmeas"]
    qcat_chisq[u_rows] = res["chisq_unmeas"]

    mask = (bp >= start_bp) & (bp <= end_bp)
    tt = t[mask]
    sel = np.flatnonzero(mask)
    return pd.DataFrame({
        "rsid": tt["rsid"].to_numpy(),
        "chr": tt["chr"].to_numpy(),
        "bp": tt["bp"].to_numpy(),
        "a1": tt["a1"].to_numpy(),
        "a2": tt["a2"].to_numpy(),
        af_col: tt[af_col].to_numpy(),
        "z": tt["z"].to_numpy(),
        "qcat_m": qcat_m[sel],
        "qcat_t": qcat_t[sel],
        "qcat_chisq": qcat_chisq[sel],
        "qcat_pval": pchisq_upper(qcat_chisq[sel], 1),
        "type": tt["type"].to_numpy(),
    })


def _pred_measured_pos(win, m_rows, start_bp, end_bp) -> np.ndarray:
    bp_m = win.table["bp"].to_numpy()[m_rows]
    return np.flatnonzero((bp_m >= start_bp) & (bp_m <= end_bp))


def qcat(
    chrom: int,
    start_bp: int,
    end_bp: int,
    wing_size: int,
    study_pop: str,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> pd.DataFrame:
    """Homogeneous-cohort causality test (reference: src/qcat.cpp).
    NOTE the default af1_cutoff here is 0.05, not 0.01
    (src/qcat.cpp:52-56)."""
    if af1_cutoff is None:
        af1_cutoff = 0.05
    win = _load(chrom, start_bp, end_bp, wing_size, input_file,
                reference_index_file, reference_data_file,
                reference_pop_desc_file, af1_cutoff, study_pop=study_pop)
    m_rows, u_rows = pipeline.partition_window(win, start_bp, end_bp)
    M = len(m_rows)
    if M <= settings.min_num_measured_snp:
        raise ValueError(
            f"Not enough number of SNPs loaded - QCAT not performed "
            f"(measured={M})")

    Gm = pipeline.genotypes_for(win, m_rows)
    Gu = pipeline.genotypes_for(win, u_rows)
    B11 = ldkernels.set_diag(ldkernels.pooled_corr(Gm, Gm),
                             1.0 + settings.lambda_)
    B21 = (ldkernels.pooled_corr(Gu, Gm)
           if len(u_rows) else np.zeros((0, M)))
    Z1 = win.table["z"].to_numpy()[m_rows]
    num_eig, res = _qcat_core(B11, B21, Z1, _pred_measured_pos(
        win, m_rows, start_bp, end_bp), settings)
    return _qcat_assemble(win, start_bp, end_bp, "af1ref", m_rows, u_rows,
                          num_eig, res)


def qcatmix(
    chrom: int,
    start_bp: int,
    end_bp: int,
    wing_size: int,
    pop_wgt_df: pd.DataFrame,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> pd.DataFrame:
    """Cosmopolitan causality test (reference: src/qcatmix.cpp).
    NOTE: unlike qcat (0.05), qcatmix's default af1_cutoff is 0.01
    (src/qcatmix.cpp:61-64)."""
    if af1_cutoff is None:
        af1_cutoff = 0.01
    win = _load(chrom, start_bp, end_bp, wing_size, input_file,
                reference_index_file, reference_data_file,
                reference_pop_desc_file, af1_cutoff,
                pop_wgt=readers.pop_wgt_map_from_df(pop_wgt_df))
    m_rows, u_rows = pipeline.partition_window(win, start_bp, end_bp)
    M, U = len(m_rows), len(u_rows)
    if M <= settings.min_num_measured_snp or U <= settings.min_num_unmeasured_snp:
        raise ValueError(
            f"Not enough number of SNPs loaded - QCATMIX not performed "
            f"(measured={M}, unmeasured={U})")

    Gm = pipeline.genotypes_for(win, m_rows)
    Gu = pipeline.genotypes_for(win, u_rows)
    std_m = ldkernels.weighted_std(Gm, win.pop_sizes, win.pop_wgts)
    std_u = ldkernels.weighted_std(Gu, win.pop_sizes, win.pop_wgts)
    B11 = ldkernels.weighted_corr(Gm, Gm, win.pop_sizes, win.pop_wgts,
                                  std_a=std_m, std_b=std_m)
    B11 = ldkernels.set_diag(B11, 1.0 + settings.lambda_)
    B21 = ldkernels.weighted_corr(Gu, Gm, win.pop_sizes, win.pop_wgts,
                                  std_a=std_u, std_b=std_m)
    Z1 = win.table["z"].to_numpy()[m_rows]
    num_eig, res = _qcat_core(B11, B21, Z1, _pred_measured_pos(
        win, m_rows, start_bp, end_bp), settings)
    return _qcat_assemble(win, start_bp, end_bp, "af1mix", m_rows, u_rows,
                          num_eig, res)


def prep_qcat(
    chrom: int,
    start_bp: int,
    end_bp: int,
    wing_size: int,
    study_pop: str,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> Dict[str, object]:
    """Raw QCAT ingredients (reference: src/prep_qcat.cpp): snplist of
    ALL kept SNPs, Z1, B11 (unit diagonal, no ridge), and B21 for all
    non-type-2 SNPs in the prediction window."""
    if af1_cutoff is None:
        af1_cutoff = 0.01
    win = _load(chrom, start_bp, end_bp, wing_size, input_file,
                reference_index_file, reference_data_file,
                reference_pop_desc_file, af1_cutoff, study_pop=study_pop)
    t = win.table
    typ = t["type"].to_numpy()
    bp = t["bp"].to_numpy()
    m_rows = np.flatnonzero(typ == 1)
    # all non-type-2 SNPs inside the prediction window (includes measured)
    p_rows = np.flatnonzero((typ != 2) & (bp >= start_bp) & (bp <= end_bp))
    M = len(m_rows)
    if M <= settings.min_num_measured_snp:
        raise ValueError(
            f"Not enough number of SNPs loaded - QCAT not performed "
            f"(measured={M})")

    Gm = pipeline.genotypes_for(win, m_rows)
    Gp = pipeline.genotypes_for(win, p_rows)
    B11 = ldkernels.set_diag(ldkernels.pooled_corr(Gm, Gm), 1.0)
    B21 = ldkernels.pooled_corr(Gp, Gm)
    snplist = pd.DataFrame({
        "rsid": t["rsid"].to_numpy(),
        "chr": t["chr"].to_numpy(),
        "bp": t["bp"].to_numpy(),
        "a1": t["a1"].to_numpy(),
        "a2": t["a2"].to_numpy(),
        "af1ref": t["af1ref"].to_numpy(),
        "z": t["z"].to_numpy(),
        "type": t["type"].to_numpy(),
    })
    return {"snplist": snplist, "z_vec": t["z"].to_numpy()[m_rows],
            "cor_mat1": B11, "cor_mat2": B21}


def prep_recessive_impute(
    chrom: int,
    start_bp: int,
    end_bp: int,
    wing_size: int,
    pop_wgt_df: pd.DataFrame,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> Dict[str, object]:
    """Imputation prep under additive/dominant/recessive codings
    (reference: src/prep_qcatmix.cpp:36-303).  Genotypes are first
    minor-allele-normalized (af1mix > 0.5 rows flipped)."""
    if af1_cutoff is None:
        af1_cutoff = 0.01
    win = _load(chrom, start_bp, end_bp, wing_size, input_file,
                reference_index_file, reference_data_file,
                reference_pop_desc_file, af1_cutoff,
                pop_wgt=readers.pop_wgt_map_from_df(pop_wgt_df))
    t = win.table
    typ = t["type"].to_numpy()
    bp = t["bp"].to_numpy()

    # minor-allele normalization over ALL kept panel SNPs (the reference
    # applies it to the whole snp_vec, src/prep_qcatmix.cpp:101)
    af = t["af1mix"].to_numpy().copy()
    z = t["z"].to_numpy().copy()
    a1 = t["a1"].to_numpy(dtype=object).copy()
    a2 = t["a2"].to_numpy(dtype=object).copy()
    rows = np.flatnonzero(win.g_row >= 0)
    G2, af2, z2, a1_2, a2_2, _ = dosage.minor_allele_update(
        win.G[win.g_row[rows]], af[rows], z[rows], a1[rows], a2[rows])
    af[rows], z[rows], a1[rows], a2[rows] = af2, z2, a1_2, a2_2
    t = t.assign(af1mix=af, z=z, a1=a1, a2=a2)

    g_of = {r: i for i, r in enumerate(rows)}
    m_rows = np.flatnonzero(typ == 1)
    p_rows = np.flatnonzero((typ != 2) & (bp >= start_bp) & (bp <= end_bp))
    M = len(m_rows)
    if M <= settings.min_num_measured_snp:
        raise ValueError("Not enough number of SNPs loaded - Recessive "
                         f"Imputation not performed (measured={M})")

    Gm = G2[[g_of[r] for r in m_rows]]
    Gp = G2[[g_of[r] for r in p_rows]]
    Gp_dom = dosage.to_dominant(Gp)
    Gp_rec = dosage.to_recessive(Gp)

    sizes, wgts = win.pop_sizes, win.pop_wgts
    std_m = ldkernels.weighted_std(Gm, sizes, wgts)

    def corr_with_measured(Gx):
        return ldkernels.weighted_corr(
            Gx, Gm, sizes, wgts, ldkernels.weighted_std(Gx, sizes, wgts),
            std_m)

    tp = t.iloc[p_rows]
    snplist = pd.DataFrame({
        "rsid": tp["rsid"].to_numpy(),
        "chr": tp["chr"].to_numpy(),
        "bp": tp["bp"].to_numpy(),
        "a1": tp["a1"].to_numpy(),
        "a2": tp["a2"].to_numpy(),
        "af1mix": tp["af1mix"].to_numpy(),
        "z": tp["z"].to_numpy(),
        "type": tp["type"].to_numpy(),
    })
    return {
        "snplist": snplist,
        "zvec": t["z"].to_numpy()[m_rows],
        "cormat": ldkernels.set_diag(
            ldkernels.weighted_corr(Gm, Gm, sizes, wgts, std_m, std_m), 1.0),
        "cormat_add": corr_with_measured(Gp),
        "cormat_dom": corr_with_measured(Gp_dom),
        "cormat_rec": corr_with_measured(Gp_rec),
    }

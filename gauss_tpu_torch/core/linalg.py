"""Dense linear algebra of the float64 host parity path.

Replaces the reference's Eigen wrappers (src/util.cpp:243-388) with
torch.linalg in float64, numerically equivalent to Eigen's
SelfAdjointEigenSolver / LLT / fullPivLu up to rounding.
"""

from __future__ import annotations

from typing import Tuple

import torch


def make_pos_def(a: torch.Tensor, min_abs_eig: float) -> torch.Tensor:
    """Clip eigenvalues below ``min_abs_eig`` and reconstruct
    (MakePosDef, src/util.cpp:302-318).  The matrix is rebuilt only when
    its smallest eigenvalue is below the threshold."""
    w, v = torch.linalg.eigh(a)
    if float(w.min()) >= min_abs_eig:
        return a
    w = torch.clamp(w, min=min_abs_eig)
    return (v * w) @ v.T


def inv_mat(a: torch.Tensor) -> torch.Tensor:
    """Matrix inverse (the reference uses Eigen fullPivLu,
    src/util.cpp:298-300)."""
    return torch.linalg.inv(a)


def cholesky_lower(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular Cholesky factor (CholeskyMat,
    src/util.cpp:271-274)."""
    return torch.linalg.cholesky(a)


def count_pc(a: torch.Tensor, eig_cutoff: float) -> int:
    """Count eigenvalues >= cutoff (CountPC, src/util.cpp:355-388: the
    size minus the number below the cutoff)."""
    w = torch.linalg.eigvalsh(a)
    return int(torch.sum(~(w < eig_cutoff)))


def cov_to_cor(cov: torch.Tensor) -> torch.Tensor:
    """Covariance -> correlation (CnvrtCovToCor, src/util.cpp:284-296)."""
    std = torch.sqrt(torch.diagonal(cov))
    return cov / torch.outer(std, std)


def cal_cov_mat(m: torch.Tensor) -> torch.Tensor:
    """Column-pairwise covariance with an n-1 denominator (CalCovMat /
    CalCov, src/util.cpp:205-253)."""
    d = m - m.mean(dim=0, keepdim=True)
    return (d.T @ d) / (m.shape[0] - 1)


def cal_cor_mat(m: torch.Tensor) -> torch.Tensor:
    """Column-pairwise Pearson correlation (CalCorMat / CalCor,
    src/util.cpp:194-241)."""
    d = m - m.mean(dim=0, keepdim=True)
    ss = torch.sqrt((d * d).sum(dim=0))
    return (d.T @ d) / torch.outer(ss, ss)


def cal_cor_vec(x: torch.Tensor, y: torch.Tensor) -> float:
    """Pearson correlation of two vectors (CalCor on Eigen vectors,
    src/util.cpp:194-203)."""
    dx, dy = x - x.mean(), y - y.mean()
    return float((dx * dy).sum()
                 / torch.sqrt((dx * dx).sum() * (dy * dy).sum()))


def rmv_pc(a: torch.Tensor, eig_cutoff: float) -> Tuple[torch.Tensor, int]:
    """Zero out principal components with eigenvalue <= cutoff (RmvPC,
    src/util.cpp:320-353; keeps components strictly above the cutoff).
    Returns (matrix, number kept)."""
    w, v = torch.linalg.eigh(a)
    if float(w[0]) >= eig_cutoff:
        return a, a.shape[0]
    keep = w > eig_cutoff
    return (v[:, keep] * w[keep]) @ v[:, keep].T, int(keep.sum())

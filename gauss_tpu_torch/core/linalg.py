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


def rmv_pc(a: torch.Tensor, eig_cutoff: float) -> Tuple[torch.Tensor, int]:
    """Zero out principal components with eigenvalue <= cutoff (RmvPC,
    src/util.cpp:320-353; keeps components strictly above the cutoff).
    Returns (matrix, number kept)."""
    w, v = torch.linalg.eigh(a)
    if float(w[0]) >= eig_cutoff:
        return a, a.shape[0]
    keep = w > eig_cutoff
    return (v[:, keep] * w[keep]) @ v[:, keep].T, int(keep.sum())

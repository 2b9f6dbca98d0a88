"""Dense linear algebra of the float64 host parity path.

Replaces the reference's Eigen wrappers (src/util.cpp:243-388) with
torch.linalg in float64, numerically equivalent to Eigen's
SelfAdjointEigenSolver / fullPivLu up to rounding.
"""

from __future__ import annotations

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

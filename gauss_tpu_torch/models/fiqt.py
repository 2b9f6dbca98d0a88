"""FIQT: winner's-curse adjustment of Z-scores.

Vectorized float64 port of the reference R function (reference:
R/fiqt.R:7-14):

    pvals <- 2*pnorm(abs(z), lower=FALSE); clip at min.p
    adj   <- p.adjust(pvals, method="fdr")
    mu.z  <- sign(z) * qnorm(adj/2, lower=FALSE)
    extreme |z| beyond qnorm(min.p/2, lower=FALSE) pass through
"""

from __future__ import annotations

import numpy as np

from ..utils.special import bh_adjust, pnorm_two_sided, qnorm_upper


def fiqt(z: np.ndarray, min_p: float = 1e-300) -> np.ndarray:
    z = np.asarray(z, dtype=np.float64)
    pvals = pnorm_two_sided(z)
    pvals = np.maximum(pvals, min_p)
    adj = bh_adjust(pvals)
    mu_z = np.sign(z) * qnorm_upper(adj / 2.0)
    extreme = np.abs(z) > qnorm_upper(min_p / 2.0)
    return np.where(extreme, z, mu_z)

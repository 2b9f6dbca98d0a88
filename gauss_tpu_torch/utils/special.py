"""Statistical special functions matching R's pnorm/pchisq/qnorm usage.

The reference calls R's C math library (reference: R::pnorm5 in
src/dist.cpp:101, R::pchisq in src/qcat.cpp:105, src/gene.cpp:509).
scipy implements the same Cody/ACM algorithms in double precision.
"""

from __future__ import annotations

import numpy as np
from scipy import special as _sp
from scipy import stats as _st


def pnorm_two_sided(z: np.ndarray) -> np.ndarray:
    """2 * P(N(0,1) > |z|) (reference: 2*R::pnorm5(|z|,0,1,lower=0))."""
    z = np.asarray(z, dtype=np.float64)
    return _sp.erfc(np.abs(z) / np.sqrt(2.0))


def pnorm_upper(x: np.ndarray) -> np.ndarray:
    """P(N(0,1) > x)."""
    return _sp.ndtr(-np.asarray(x, dtype=np.float64))


def qnorm_upper(p: np.ndarray) -> np.ndarray:
    """Inverse upper-tail normal quantile (R qnorm(lower=FALSE))."""
    return -_sp.ndtri(np.asarray(p, dtype=np.float64))


def pchisq_upper(x: np.ndarray, df) -> np.ndarray:
    """P(chi2_df > x) (reference: R::pchisq(x, df, lower=0))."""
    return _sp.gammaincc(np.asarray(df, dtype=np.float64) / 2.0,
                         np.asarray(x, dtype=np.float64) / 2.0)


def bh_adjust(p: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg FDR adjustment, identical to R p.adjust(method
    ='fdr'): p_adj[i] = min_{j: p_j >= p_i} ( n/rank_j * p_j ), capped at 1."""
    p = np.asarray(p, dtype=np.float64)
    n = p.size
    order = np.argsort(p)[::-1]  # descending
    ranked = p[order] * n / np.arange(n, 0, -1)
    cummin = np.minimum.accumulate(ranked)
    out = np.empty(n)
    out[order] = np.minimum(cummin, 1.0)
    return out


def quantile_type7(x: np.ndarray, prob: float) -> float:
    """R stats::quantile type 7 (the default; used by prep_zmix5's
    ancestry-informative cutoff, reference src/zmix.cpp:122-128).
    numpy's 'linear' interpolation is the same estimator."""
    return float(np.quantile(np.asarray(x, dtype=np.float64), prob,
                             method="linear"))

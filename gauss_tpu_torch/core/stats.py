"""Correlation/covariance from per-population sufficient statistics.

The float64 host parity path.  Every correlation the reference computes
with scalar loops (CalCor src/util.cpp:49-70, CalWgtCov
src/util.cpp:103-124) is a function of per-population statistics

    S_k[i]    = sum_j G_k[i, j]          (allele-count row sums)
    Q_k[i]    = sum_j G_k[i, j]^2
    C_k[i,i'] = sum_j G_k[i, j] G_k[i', j]   (cross products = G_k G_k^T)

Dosages are in {0, 1, 2}, so each of these is an integer below 2^24 for
any real panel and a float32 matrix product computes it exactly.  The
combines cancel heavily (m*sum_xy - sum_x*sum_y), so they run in
float64, term for term in the reference's population order.

Inputs are int8 tensors ``[N, S]`` on any device; outputs are float64.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def segment_bounds(pop_sizes: Sequence[int]) -> np.ndarray:
    """Cumulative subject-axis boundaries for population segments."""
    return np.concatenate([[0], np.cumsum(np.asarray(pop_sizes,
                                                     dtype=np.int64))])


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def pop_cross_products(Ga: torch.Tensor, Gb: torch.Tensor,
                       bounds: np.ndarray) -> torch.Tensor:
    """Per-population cross products C[P, Na, Nb] = G_ak @ G_bk^T, exact
    integers in float32."""
    outs = []
    for k in range(len(bounds) - 1):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        outs.append(_f32(Ga[:, lo:hi]) @ _f32(Gb[:, lo:hi]).T)
    return torch.stack(outs)


def pop_row_stats(G: torch.Tensor, bounds: np.ndarray
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-population row sums S[N, P] and squared sums Q[N, P], exact
    integers in float32."""
    Ss, Qs = [], []
    for k in range(len(bounds) - 1):
        g = _f32(G[:, int(bounds[k]):int(bounds[k + 1])])
        Ss.append(g.sum(dim=1))
        Qs.append((g * g).sum(dim=1))
    return torch.stack(Ss, dim=1), torch.stack(Qs, dim=1)


def wgt_cov_combine(C: torch.Tensor, Sa: torch.Tensor, Sb: torch.Tensor,
                    m: np.ndarray, w: np.ndarray) -> torch.Tensor:
    """Weighted covariance matrix: CalWgtCov (src/util.cpp:103-124) on
    all pairs, accumulated in population order with the reference's
    association of products::

        wsumcov   += (w_k * factor_k) * (m_k*sumxy - sumx*sumy)
        wsum_mimj += (w_k * (sumx/m_k)) * (sumy/m_k)
        wsum_mi   += w_k * (sumx/m_k)          (and mj alike)
        result = wsumcov + wsum_mimj - wsum_mi*wsum_mj

    with factor_k = m_k/(m_k-1).  C: [P, Na, Nb] exact cross products;
    Sa: [Na, P]; Sb: [Nb, P]; m, w: float64 sizes / weights.  Returns
    float64 [Na, Nb]."""
    m = np.asarray(m, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    factor = m / (m - 1.0)
    f64 = dict(dtype=torch.float64, device=C.device)
    Na, Nb = C.shape[1], C.shape[2]
    cov = torch.zeros((Na, Nb), **f64)
    mimj = torch.zeros((Na, Nb), **f64)
    mi = torch.zeros((Na,), **f64)
    mj = torch.zeros((Nb,), **f64)
    for k in range(C.shape[0]):
        sx = Sa[:, k].to(torch.float64)
        sy = Sb[:, k].to(torch.float64)
        Ck = C[k].to(torch.float64)
        cov = cov + (w[k] * factor[k]) * (m[k] * Ck
                                          - sx[:, None] * sy[None, :])
        mimj = mimj + (w[k] * (sx / m[k]))[:, None] * (sy / m[k])[None, :]
        mi = mi + w[k] * (sx / m[k])
        mj = mj + w[k] * (sy / m[k])
    return (cov + mimj) - mi[:, None] * mj[None, :]


def wgt_var_combine(Q: torch.Tensor, S: torch.Tensor,
                    m: np.ndarray, w: np.ndarray) -> torch.Tensor:
    """CalWgtCov(x, x): per-SNP weighted variance.  Q, S: [N, P]."""
    m = np.asarray(m, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    factor = m / (m - 1.0)
    f64 = dict(dtype=torch.float64, device=Q.device)
    N = Q.shape[0]
    var = torch.zeros((N,), **f64)
    mimj = torch.zeros((N,), **f64)
    mi = torch.zeros((N,), **f64)
    for k in range(Q.shape[1]):
        s = S[:, k].to(torch.float64)
        q = Q[:, k].to(torch.float64)
        var = var + (w[k] * factor[k]) * (m[k] * q - s * s)
        mimj = mimj + (w[k] * (s / m[k])) * (s / m[k])
        mi = mi + w[k] * (s / m[k])
    return (var + mimj) - mi * mi


def pooled_corr_combine(Cp: torch.Tensor, Sa: torch.Tensor,
                        Sb: torch.Tensor, Qa: torch.Tensor,
                        Qb: torch.Tensor, n: float) -> torch.Tensor:
    """Unweighted pooled Pearson correlation (CalCor,
    src/util.cpp:49-70)::

        r = (n*sumxy - sumx*sumy)
            / ( sqrt(n*sumxsq - sumx^2) * sqrt(n*sumysq - sumy^2) )

    Returns float64 [Na, Nb]."""
    n = float(n)
    sa, sb = Sa.to(torch.float64), Sb.to(torch.float64)
    qa, qb = Qa.to(torch.float64), Qb.to(torch.float64)
    numer = n * Cp.to(torch.float64) - sa[:, None] * sb[None, :]
    da = torch.sqrt(n * qa - sa * sa)
    db = torch.sqrt(n * qb - sb * sb)
    return numer / (da[:, None] * db[None, :])


def per_pop_corr_matrices(G: torch.Tensor, bounds: np.ndarray
                          ) -> torch.Tensor:
    """Per-population Pearson correlation matrices R[P, N, N], float64:
    the per-string CalCor (src/util.cpp:153-169) of the prep_zmix
    family."""
    C = pop_cross_products(G, G, bounds)
    S, Q = pop_row_stats(G, bounds)
    return torch.stack([
        pooled_corr_combine(C[k], S[:, k], S[:, k], Q[:, k], Q[:, k],
                            float(int(bounds[k + 1]) - int(bounds[k])))
        for k in range(C.shape[0])])


def pooled_corr_matrix(Ga: torch.Tensor, Gb: torch.Tensor) -> torch.Tensor:
    """Pooled CalCor over all subject columns of Ga/Gb (populations
    concatenated), as dist uses it."""
    a, b = _f32(Ga), _f32(Gb)
    return pooled_corr_combine(a @ b.T, a.sum(dim=1), b.sum(dim=1),
                               (a * a).sum(dim=1), (b * b).sum(dim=1),
                               float(Ga.shape[1]))

"""Windowed LD blocks of the float64 host path.

int8 dosage blocks in, float64 correlation structures out (numpy, as the
per-call models use them): exact integer sufficient statistics in
float32 and float64 combines (``core/stats.py``).  The reference computes
these with scalar loops (src/distmix.cpp:188-236, src/computeLD.cpp:
104-116, src/dist.cpp:171-210).  Everything runs on the CPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import stats


def _t(G: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(G))


def _f64(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float64)


def weighted_std(G: np.ndarray, pop_sizes, wgts) -> np.ndarray:
    """Per-SNP weighted standard deviations, SNP_STD_VEC in the reference
    (src/distmix.cpp:179-187): sqrt(CalWgtCov(x, x))."""
    S, Q = stats.pop_row_stats(_t(G), stats.segment_bounds(pop_sizes))
    return torch.sqrt(stats.wgt_var_combine(Q, S, _f64(pop_sizes),
                                            _f64(wgts))).numpy()


def weighted_corr(Ga: np.ndarray, Gb: np.ndarray, pop_sizes, wgts,
                  std_a: Optional[np.ndarray] = None,
                  std_b: Optional[np.ndarray] = None) -> np.ndarray:
    """Weighted correlation block: CalWgtCov(i,j) / (std_i std_j)
    (src/distmix.cpp:188-200).

    A zero-variance SNP divides 0/0 here, as the reference does (it
    divides by SNP_STD_VEC entries that can be 0): the NaN propagates to
    that SNP's row and column by design (README deviations)."""
    bounds = stats.segment_bounds(pop_sizes)
    a, b = _t(Ga), _t(Gb)
    C = stats.pop_cross_products(a, b, bounds)
    Sa, _ = stats.pop_row_stats(a, bounds)
    Sb, _ = stats.pop_row_stats(b, bounds)
    cov = stats.wgt_cov_combine(C, Sa, Sb, _f64(pop_sizes), _f64(wgts))
    if std_a is None:
        std_a = weighted_std(Ga, pop_sizes, wgts)
    if std_b is None:
        std_b = weighted_std(Gb, pop_sizes, wgts)
    sa, sb = torch.from_numpy(_f64(std_a)), torch.from_numpy(_f64(std_b))
    return (cov / (sa[:, None] * sb[None, :])).numpy()


def pooled_corr(Ga: np.ndarray, Gb: np.ndarray) -> np.ndarray:
    """Unweighted pooled correlation block (CalCor over concatenated
    population strings, src/util.cpp:49-70)."""
    return stats.pooled_corr_matrix(_t(Ga), _t(Gb)).numpy()


def per_pop_corr(G: np.ndarray, pop_sizes) -> np.ndarray:
    """Per-population correlation matrices [P, N, N] (per-string CalCor,
    src/util.cpp:153-169)."""
    return stats.per_pop_corr_matrices(
        _t(G), stats.segment_bounds(pop_sizes)).numpy()


def set_diag(a: np.ndarray, value: float) -> np.ndarray:
    """Overwrite the diagonal (the reference writes diagonals explicitly:
    1.0 for computeLD, 1+lambda for B11)."""
    out = a.copy()
    np.fill_diagonal(out, value)
    return out

"""Simplex-constrained quadratic programming.

Solves the zmix ancestry-weights QP (reference: R/zmix.R:85-97,
quadprog::solve.QP with Amat = [1 | I | -I], bvec = [1, 0.., -1..],
meq = 1):

    min_w  (1/2) w^T D w - d^T w
    s.t.   sum(w) = 1,  0 <= w_i <= 1

via a primal active-set method (exact in finitely many steps, like the
Goldfarb-Idnani solver R uses).  Problem sizes are tiny (<= number of
panel populations), so dense float64 solves are used throughout.
"""

from __future__ import annotations

import numpy as np


def solve_simplex_qp(D: np.ndarray, d: np.ndarray, tol: float = 1e-12,
                     max_iter: int = 1000) -> np.ndarray:
    """Minimize 1/2 w'Dw - d'w subject to sum(w)=1, 0<=w<=1.

    D must be symmetric positive definite (the zmix cross-product matrix
    X'X; quadprog has the same requirement).
    """
    n = D.shape[0]
    w = np.full(n, 1.0 / n)
    # active bound state: 0 free, -1 at lower (0), +1 at upper (1)
    state = np.zeros(n, dtype=np.int8)

    def solve_eq(free: np.ndarray, fixed_vals: np.ndarray) -> np.ndarray:
        """Equality-constrained solve on the free coordinates:
        min 1/2 w'Dw - d'w  s.t. sum(w_free) = 1 - sum(fixed)."""
        nf = free.sum()
        idx = np.flatnonzero(free)
        Dff = D[np.ix_(idx, idx)]
        rhs_lin = d[idx] - D[np.ix_(idx, ~free)] @ fixed_vals[~free] \
            if (~free).any() else d[idx]
        # KKT system: [Dff  1; 1' 0] [w; mu] = [rhs; 1 - sum(fixed)]
        K = np.zeros((nf + 1, nf + 1))
        K[:nf, :nf] = Dff
        K[:nf, nf] = 1.0
        K[nf, :nf] = 1.0
        rhs = np.concatenate([rhs_lin, [1.0 - fixed_vals[~free].sum()
                                        if (~free).any() else 1.0]])
        sol = np.linalg.solve(K, rhs)
        out = fixed_vals.copy()
        out[idx] = sol[:nf]
        return out, sol[nf]

    for _ in range(max_iter):
        free = state == 0
        fixed_vals = np.where(state > 0, 1.0, 0.0)
        if not free.any():
            # all variables at bounds; release the most violating one
            g = D @ fixed_vals - d
            lam = -(g.min())
            rel = np.argmin(np.where(state != 0, g * -state, np.inf))
            state[rel] = 0
            continue
        w_new, mu = solve_eq(free, fixed_vals)

        # step toward w_new, stopping at the first bound violation
        if np.all(w_new[free] >= -tol) and np.all(w_new[free] <= 1 + tol):
            w = np.clip(w_new, 0.0, 1.0)
            # check KKT multipliers for bound-active coordinates
            g = D @ w - d + mu  # gradient of Lagrangian wrt w (per coord)
            # lower-active: need g >= 0 (multiplier >= 0); upper: g <= 0
            viol_low = (state == -1) & (g < -tol)
            viol_up = (state == 1) & (g > tol)
            if not viol_low.any() and not viol_up.any():
                return w
            # release the worst violator
            cand = np.where(viol_low, -g, np.where(viol_up, g, -np.inf))
            state[np.argmax(cand)] = 0
            continue

        # find blocking constraint along the segment w -> w_new
        dvec = w_new - w
        alpha = 1.0
        blk, blk_state = -1, 0
        for i in np.flatnonzero(free):
            if dvec[i] < -tol:
                a = (0.0 - w[i]) / dvec[i]
                if a < alpha:
                    alpha, blk, blk_state = a, i, -1
            elif dvec[i] > tol:
                a = (1.0 - w[i]) / dvec[i]
                if a < alpha:
                    alpha, blk, blk_state = a, i, 1
        w = w + max(alpha, 0.0) * dvec
        if blk >= 0:
            w[blk] = 0.0 if blk_state == -1 else 1.0
            state[blk] = blk_state
        else:
            w = np.clip(w, 0.0, 1.0)

    raise RuntimeError("solve_simplex_qp did not converge")

"""Entry point for a compile-and-run check on one device: the resident
distmix imputation kernel on a toy window batch.

* entry(device) -> (fn, example_args): the port's resident impute kernel
  (``ops/window_kernel.build_resident_region_kernel``) and its arguments
  on ``device``; ``fn(*example_args)`` gives the stacked [2, W, Up]
  (z, info).  On a CUDA device the preparation gathers with K2 and the
  call launches K1; on the CPU both take their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch


def _toy_window(n_windows=2, M=24, U=16, pop_sizes=(12, 20, 8), seed=0):
    rng = np.random.default_rng(seed)
    S = int(sum(pop_sizes))
    Gm = rng.integers(0, 3, size=(n_windows, M, S), dtype=np.int8)
    Gu = rng.integers(0, 3, size=(n_windows, U, S), dtype=np.int8)
    Z1 = rng.standard_normal((n_windows, M))
    m_mask = np.ones((n_windows, M), dtype=np.float32)
    u_mask = np.ones((n_windows, U), dtype=np.float32)
    m_mask[:, -3:] = 0.0  # exercise padding/masking
    u_mask[:, -2:] = 0.0
    Gm[:, -3:] = 0
    Gu[:, -2:] = 0
    Z1[:, -3:] = 0.0
    return Gm, Gu, Z1, m_mask, u_mask


def entry(device):
    """The resident impute kernel and its arguments on ``device`` for the
    toy window batch: every window's measured / unmeasured rows are one
    aligned band of a panel built from the toy blocks (population
    segments zero-padded to K1's K_CHUNK columns)."""
    from .ops.gram import K_CHUNK, ROW_TILE
    from .ops.window_kernel import (WindowKernelSpec,
                                    build_resident_region_kernel,
                                    pad_pop_segments,
                                    prepare_resident_panel)

    device = torch.device(device)
    pop_sizes = (12, 20, 8)
    Gm, Gu, Z1, m_mask, u_mask = _toy_window(pop_sizes=pop_sizes)
    W, M, U = Gm.shape[0], Gm.shape[1], Gu.shape[1]
    Mp = -(-M // ROW_TILE) * ROW_TILE
    Up = -(-U // ROW_TILE) * ROW_TILE
    panel, padded = pad_pop_segments(
        np.concatenate([Gm.reshape(W * M, -1), Gu.reshape(W * U, -1)]),
        pop_sizes, multiple=K_CHUNK)
    spec = WindowKernelSpec(pop_sizes=pop_sizes, pop_sizes_padded=padded,
                            wgts=(0.5, 0.3, 0.2))

    def band_rows(first, n, band):
        rows = np.full(W * band, -1, dtype=np.int32)
        for w in range(W):
            rows[w * band:w * band + n] = first + w * n + np.arange(n)
        return torch.from_numpy(rows).to(device)

    G_dev = torch.from_numpy(np.ascontiguousarray(panel)).to(device)
    Xm, Spm, Mum, _ = prepare_resident_panel(G_dev, band_rows(0, M, Mp),
                                             None, spec)
    Xu, Spu, Muu, Vu = prepare_resident_panel(
        G_dev, band_rows(W * M, U, Up), None, spec)

    def padded_to(a, width):
        out = np.zeros((W, width), dtype=np.float32)
        out[:, :a.shape[1]] = a
        return torch.from_numpy(out).to(device)

    m_t0 = torch.arange(W, dtype=torch.int32, device=device) * Mp
    u_t0 = torch.arange(W, dtype=torch.int32, device=device) * Up
    fn = build_resident_region_kernel(spec, Mp, Up)
    args = (Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0,
            padded_to(Z1, Mp), padded_to(m_mask, Mp), padded_to(u_mask, Up))
    return fn, args

"""computeLD / simulateLD: ancestry-weighted LD matrices, one window per
call, in float64 on the host.

* computeLD (reference: src/computeLD.cpp:26-166)
* simulateLD (reference: src/simulateLD.cpp:32-254)

The genome engine's batched version of computeLD is
``models/genome.PreparedRun.ld_region``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import pandas as pd

from ..config import DEFAULT_SETTINGS, Settings
from ..core import ldkernels
from ..io import readers
from . import pipeline
from .dist import _load


def _measured(win, settings: Settings) -> np.ndarray:
    measured = np.flatnonzero(win.table["type"].to_numpy() == 1)
    if len(measured) <= settings.min_num_measured_snp:
        raise ValueError(
            f"Not enough number of SNPs loaded - computeLD not performed "
            f"(measured={len(measured)})")
    return measured


def _snplist(win, measured) -> pd.DataFrame:
    t = win.table.iloc[measured]
    return pd.DataFrame({
        "rsid": t["rsid"].to_numpy(),
        "chr": t["chr"].to_numpy(),
        "bp": t["bp"].to_numpy(),
        "a1": t["a1"].to_numpy(),
        "a2": t["a2"].to_numpy(),
        "af1mix": t["af1mix"].to_numpy(),
    })


def compute_ld(
    chrom: int,
    start_bp: int,
    end_bp: int,
    pop_wgt_df: pd.DataFrame,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
) -> Dict[str, object]:
    """Ancestry-weighted LD (correlation) matrix of the measured SNPs
    (src/computeLD.cpp): wing_size=0, weighted correlations among type-1
    SNPs with unit diagonal.  Returns {"snplist": DataFrame,
    "cormat": float64 [M, M]}."""
    if af1_cutoff is None:
        af1_cutoff = 0.01
    win = _load(chrom, start_bp, end_bp, 0, input_file,
                reference_index_file, reference_data_file,
                reference_pop_desc_file, af1_cutoff,
                pop_wgt=readers.pop_wgt_map_from_df(pop_wgt_df))
    measured = _measured(win, settings)
    G = pipeline.genotypes_for(win, measured)
    std = ldkernels.weighted_std(G, win.pop_sizes, win.pop_wgts)
    cor = ldkernels.weighted_corr(G, G, win.pop_sizes, win.pop_wgts,
                                  std_a=std, std_b=std)
    return {"snplist": _snplist(win, measured),
            "cormat": ldkernels.set_diag(cor, 1.0)}


def simulate_ld(
    chrom: int,
    start_bp: int,
    end_bp: int,
    pop_wgt_df: pd.DataFrame,
    sim_size: int,
    input_file: str,
    reference_index_file: str,
    reference_data_file: str,
    reference_pop_desc_file: str,
    af1_cutoff: Optional[float] = None,
    settings: Settings = DEFAULT_SETTINGS,
    seed: Optional[int] = None,
) -> Dict[str, object]:
    """LD matrix of a simulated cohort (reference: src/simulateLD.cpp).

    Per selected population k, draws floor(wgt_k * sim_size) subjects
    with replacement from the panel (numpy's default_rng(seed)), then
    computes the plain Pearson correlation matrix over the simulated
    subjects.  The reference seeds std::mt19937 from std::random_device;
    pass ``seed`` for reproducibility."""
    if af1_cutoff is None:
        af1_cutoff = 0.01
    pop_wgt = readers.pop_wgt_map_from_df(pop_wgt_df)
    win = _load(chrom, start_bp, end_bp, 0, input_file,
                reference_index_file, reference_data_file,
                reference_pop_desc_file, af1_cutoff, pop_wgt=pop_wgt)
    measured = _measured(win, settings)
    G = pipeline.genotypes_for(win, measured)

    rng = np.random.default_rng(seed)
    bounds = np.concatenate([[0], np.cumsum(win.pop_sizes)])
    cols = []
    for j, k in enumerate(win.pop_index):
        n_sim = int(pop_wgt[win.desc.pops[k]] * sim_size)  # (int) cast
        if n_sim <= 0:
            continue
        draw = rng.integers(0, int(win.pop_sizes[j]), size=n_sim)
        cols.append(G[:, bounds[j]:bounds[j + 1]][:, draw])
    sim = np.concatenate(cols, axis=1).astype(np.float64)

    # Pearson correlation across simulated subjects
    # (src/simulateLD.cpp:257-271)
    n = sim.shape[1]
    s = sim.sum(axis=1)
    q = (sim * sim).sum(axis=1)
    numer = n * (sim @ sim.T) - np.outer(s, s)
    den = np.sqrt(n * q - s * s)
    cor = numer / np.outer(den, den)
    np.fill_diagonal(cor, 1.0)
    return {"snplist": _snplist(win, measured), "cormat": cor}

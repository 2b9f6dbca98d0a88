"""State carried across from the JAX package.

This system has no weights: its state is the decoded panel (a
PanelStore) and the join that ``prepare_mix`` / ``prepare_homog`` derive
from it.  The port never imports the JAX package, so the panel crosses
as plain numpy/pandas fields; the join is recomputed from them and
matches the JAX run's exactly (tests/test_torch_host.py,
tests/test_torch_genome.py).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import pandas as pd

from .io.readers import PopDesc
from .models.genome import PanelStore


def panel_from_numpy(index_df: pd.DataFrame, G: np.ndarray, af: np.ndarray,
                     pops: Sequence[str], sizes: Sequence[int],
                     sup_pops: Sequence[str]) -> PanelStore:
    """The port's PanelStore from the fields of a JAX-package PanelStore
    (``index``, ``G``, ``af`` and ``desc.pops/sizes/sup_pops``)."""
    G = np.asarray(G)
    if G.dtype != np.int8 or G.ndim != 2:
        raise TypeError(f"G must be int8 [n_snps, subjects], got {G.dtype} "
                        f"{G.shape}")
    desc = PopDesc(pops=list(pops),
                   sizes=np.asarray(sizes, dtype=np.int64),
                   sup_pops=list(sup_pops))
    if int(desc.sizes.sum()) != G.shape[1] or len(index_df) != G.shape[0]:
        raise ValueError("panel fields disagree on their shapes")
    return PanelStore(index=index_df.copy(), G=G,
                      af=np.asarray(af, dtype=np.float64), desc=desc)

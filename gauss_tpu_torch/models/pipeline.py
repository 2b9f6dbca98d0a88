"""Shared analysis pipeline: window loading, AF filtering, partitioning.

Reproduces the reference's per-call flow (e.g. distmix wrapper,
src/distmix.cpp:30-135):

    read_ref_desc -> init_pop_flag[_wgt]_vec -> ReadInputZ ->
    ReadReferenceIndex -> MakeSnpVec[Mix] -> ReadGenotype -> kernel

with the per-SNP bgzf seek loops replaced by one bulk panel decode.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

from ..config import Settings, DEFAULT_SETTINGS, PanelFiles
from ..io import readers
from ..io.panel import PanelReader, read_panel_index
from ..core import variants


@dataclasses.dataclass
class WindowData:
    """A fully-loaded analysis window."""

    table: pd.DataFrame          # variant table in MapKey order (kept SNPs)
    G: Optional[np.ndarray]      # int8 [n_panel_rows, n_sel_subjects]
    g_row: np.ndarray            # int64: table row -> G row (-1 for type 2)
    pop_sizes: np.ndarray        # subject counts of selected pops
    pop_index: np.ndarray        # selected pop indices (panel order)
    desc: readers.PopDesc
    pop_wgts: Optional[np.ndarray]  # aligned with pop_sizes (mix mode)
    num_samples: int             # pooled selected subject count


def _ceil5(x: np.ndarray) -> np.ndarray:
    """Round UP to 5 decimals (reference: src/gauss.cpp:591:
    ceil(af*1e5)/1e5)."""
    return np.ceil(x * 100000.0) / 100000.0


def load_window(
    panel: PanelFiles,
    input_df: pd.DataFrame,
    *,
    chrom: int = 0,
    start_bp: int = 0,
    end_bp: int = 0,
    wing_size: int = 0,
    study_pop: Optional[str] = None,
    pop_wgt: Optional[Dict[str, float]] = None,
    af1_cutoff: float = 0.01,
    all_snps: bool = False,
    add_unmeasured: bool = True,
    flip_af1study: bool = False,
    want_genotypes: bool = True,
) -> WindowData:
    """Load one analysis window end to end.

    Exactly one of ``study_pop`` (homogeneous: dist/qcat/jepeg) or
    ``pop_wgt`` (cosmopolitan: distmix/computeLD/...) must be given.

    AF filter semantics:

    * homogeneous (reference MakeSnpVec, src/gauss.cpp:543-604):
      af1ref = pooled allele count over flagged pops / (2*N), rounded UP
      to 5 decimals; keep if af1_cutoff < af1ref < 1-af1_cutoff.
    * cosmopolitan (reference MakeSnpVecMix, src/gauss.cpp:631-693):
      af1mix = sum_k wgt_k * af1_k over flagged pops (no rounding);
      same cutoff.

    Type-2 SNPs (measured, absent from the panel) have no panel row;
    the reference "reads" one at an undefined file position (fpos
    defaults to -1, the failed seek leaves the stream where the
    previous map entry ended -- src/snp.cpp:31, src/gauss.cpp:561) and
    filters on the parsed garbage: in the common trailing case the read
    hits EOF, af1ref = 0/0 = NaN, the cutoff comparison is false and
    the SNP is DROPPED from snp_vec (verified against the compiled
    reference binary, tests/test_ref_harness.py).  We drop type-2 rows
    unconditionally -- identical to the reference for trailing type-2
    SNPs, and deterministic (instead of stale-line-dependent) for
    mid-table ones.
    """
    desc = readers.read_pop_desc(panel.pop_desc_file)
    if (study_pop is None) == (pop_wgt is None):
        raise ValueError("specify exactly one of study_pop / pop_wgt")
    if study_pop is not None:
        flags = readers.init_pop_flags(desc, study_pop)
        wgts = None
    else:
        flags, wgts = readers.init_pop_flag_wgts(desc, pop_wgt)
        if flags.sum() == 0:
            raise ValueError("no panel population matches pop_wgt")

    idx = read_panel_index(
        panel.index_file,
        chrom=0 if all_snps else chrom,
        start_bp=None if all_snps else start_bp,
        end_bp=None if all_snps else end_bp,
        wing_size=wing_size,
    )
    table = variants.join_reference_index(
        input_df, idx, add_unmeasured=add_unmeasured,
        flip_af1study=flip_af1study)

    # Decode panel rows once for every SNP with a panel row.
    reader = PanelReader(panel.data_file, desc)
    has_row = (table["fpos"].to_numpy() >= 0)
    fpos = table["fpos"].to_numpy()[has_row]
    dec = reader.decode_rows(fpos, pop_flags=flags,
                             want_genotypes=want_genotypes, want_af=True)

    n = len(table)
    g_row = np.full(n, -1, dtype=np.int64)
    g_row[has_row] = np.arange(int(has_row.sum()))

    # AF computation + filter; type-2 rows (no panel row) are dropped
    # like the reference's MakeSnpVec[Mix] NaN-filter drops them (see
    # docstring)
    sel = dec.pop_index
    keep = np.asarray(has_row).copy()
    if study_pop is not None:
        af1 = np.full(n, np.nan)
        if has_row.any():
            if want_genotypes:
                bounds = np.concatenate([[0], np.cumsum(dec.pop_sizes)])
                counts = np.add.reduce(
                    [dec.G[:, bounds[k]:bounds[k + 1]].astype(np.int64).sum(axis=1)
                     for k in range(len(dec.pop_sizes))])
                num_subj = float(dec.pop_sizes.sum())
                af_rows = counts / (2.0 * num_subj)
            else:
                # fall back to per-pop AFs weighted by pop size: the
                # reference always counts alleles; AF-only mode is used
                # by analyses that never call MakeSnpVec.
                sizes = desc.sizes[sel].astype(np.float64)
                af_rows = (dec.af[:, sel] * sizes).sum(axis=1) / sizes.sum()
            af_rows = _ceil5(af_rows)
            af1[has_row] = af_rows
        table = table.assign(af1ref=af1)
        keep[has_row] = (af1[has_row] > af1_cutoff) & (af1[has_row] < 1 - af1_cutoff)
        num_samples = int(desc.sizes[sel].sum())
    else:
        af1 = np.full(n, np.nan)
        if has_row.any():
            af_rows = dec.af[:, sel] @ wgts
            af1[has_row] = af_rows
        table = table.assign(af1mix=af1)
        keep[has_row] = (af1[has_row] > af1_cutoff) & (af1[has_row] < 1 - af1_cutoff)
        num_samples = int(desc.sizes[sel].sum())

    table = table[keep].reset_index(drop=True)
    g_row = g_row[keep]

    return WindowData(
        table=table,
        G=dec.G,
        g_row=g_row,
        pop_sizes=dec.pop_sizes,
        pop_index=dec.pop_index,
        desc=desc,
        pop_wgts=wgts,
        num_samples=num_samples,
    )


def partition_window(
    win: WindowData, start_bp: int, end_bp: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Split into (measured rows, unmeasured-in-prediction-window rows).

    Measured = type 1 anywhere in the extended window; unmeasured =
    type 0 with bp inside [start_bp, end_bp] (reference:
    src/dist.cpp:129-140).  Returns table row indices.
    """
    t = win.table
    typ = t["type"].to_numpy()
    bp = t["bp"].to_numpy()
    measured = np.flatnonzero(typ == 1)
    unmeasured = np.flatnonzero((typ == 0) & (bp >= start_bp) & (bp <= end_bp))
    return measured, unmeasured


def genotypes_for(win: WindowData, rows: np.ndarray) -> np.ndarray:
    """Gather the int8 dosage matrix for the given table rows."""
    gr = win.g_row[rows]
    if (gr < 0).any():
        raise ValueError("requested genotypes for SNPs without panel rows")
    return win.G[gr]

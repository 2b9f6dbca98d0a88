"""Text-input readers: GWAS summary stats, AF inputs, population
descriptions, SNP annotation.

File formats follow the reference's de-facto wire protocol
(SURVEY.md section 2.4):

* Z input (reference: src/gauss.cpp:149-152): whitespace-delimited,
  header line skipped, columns by POSITION: rsid chr bp a1 a2 z.
* AF input (reference: src/gauss.cpp:239-243): rsid chr bp a1 a2 af1.
* Pop description (reference: src/gauss.cpp:973-985): TSV with header,
  columns Population_Abbreviation, N, Super_Population.
* Annotation (reference: src/gauss.cpp:1305-1308):
  rsid chr bp a1 a2 geneid categ wgt.
"""

from __future__ import annotations

import dataclasses
import io as _io
from typing import Dict, List, Optional

import numpy as np
import pandas as pd

# Annotation category name -> number (reference: src/gauss.cpp:1319-1330)
CATEG_NUM = {
    "PROTEIN": 0,
    "TFBS": 1,
    "WTH_HAIR": 2,
    "WTH_TARGET": 3,
    "CIS_EQTL": 4,
    "TRANS_EQTL": 5,
}
# Display names (reference: src/gene.cpp:28-44)
CATEG_NAME = ["PFS", "TFB", "STR", "TAR", "CIS", "TRN"]


def _read_ws_table(path: str, names: List[str], dtypes: Dict[str, object]) -> pd.DataFrame:
    """Whitespace table with one header line that is skipped (positional cols)."""
    df = pd.read_csv(
        path,
        sep=r"\s+",
        header=None,
        skiprows=1,
        names=names,
        usecols=range(len(names)),
        dtype=dtypes,
    )
    return df


def read_input_z(
    path: str,
    chrom: int = 0,
    start_bp: int = 0,
    end_bp: int = 0,
    wing_size: int = 0,
    all_snps: bool = False,
) -> pd.DataFrame:
    """Read GWAS Z-scores (reference: ReadInputZ, src/gauss.cpp:121-190).

    When ``all_snps`` is False, keeps only rows with matching chromosome
    (if chrom > 0) and bp within [start_bp - wing_size, end_bp + wing_size].
    Duplicate (chr,bp,a1,a2) keys keep the LAST occurrence (std::map
    overwrite semantics in the reference).
    """
    df = _read_ws_table(
        path,
        ["rsid", "chr", "bp", "a1", "a2", "z"],
        {"rsid": str, "chr": np.int32, "bp": np.int64, "a1": str, "a2": str, "z": np.float64},
    )
    if not all_snps:
        if chrom > 0:
            df = df[df["chr"] == chrom]
        df = df[(df["bp"] >= start_bp - wing_size) & (df["bp"] <= end_bp + wing_size)]
    df = df.drop_duplicates(subset=["chr", "bp", "a1", "a2"], keep="last")
    df = df.reset_index(drop=True)
    df["info"] = 1.0
    df["type"] = np.int8(2)  # measured, not (yet) in reference panel
    return df


def read_input_af(path: str) -> pd.DataFrame:
    """Read study allele frequencies (reference: ReadInputAf,
    src/gauss.cpp:211-262)."""
    df = _read_ws_table(
        path,
        ["rsid", "chr", "bp", "a1", "a2", "af1study"],
        {"rsid": str, "chr": np.int32, "bp": np.int64, "a1": str, "a2": str, "af1study": np.float64},
    )
    df = df.drop_duplicates(subset=["chr", "bp", "a1", "a2"], keep="last")
    df = df.reset_index(drop=True)
    df["type"] = np.int8(2)
    return df


@dataclasses.dataclass
class PopDesc:
    """Reference-panel population metadata (reference: read_ref_desc,
    src/gauss.cpp:951-993)."""

    pops: List[str]
    sizes: np.ndarray          # int per population
    sup_pops: List[str]

    @property
    def num_pops(self) -> int:
        return len(self.pops)

    @property
    def total_subjects(self) -> int:
        return int(self.sizes.sum())

    def sup_pop_order(self) -> List[str]:
        """Unique super-populations in first-appearance order
        (reference: src/zmix.cpp:290-306)."""
        seen: Dict[str, None] = {}
        for sp in self.sup_pops:
            seen.setdefault(sp, None)
        return list(seen)

    def sup_pop_indices(self) -> Dict[str, List[int]]:
        out: Dict[str, List[int]] = {}
        for i, sp in enumerate(self.sup_pops):
            out.setdefault(sp, []).append(i)
        return out


def read_pop_desc(path: str) -> PopDesc:
    df = pd.read_csv(path, sep=r"\s+", header=None, skiprows=1,
                     names=["pop", "n", "sup"], usecols=[0, 1, 2],
                     dtype={"pop": str, "n": np.int64, "sup": str})
    return PopDesc(
        pops=df["pop"].tolist(),
        sizes=df["n"].to_numpy(),
        sup_pops=df["sup"].tolist(),
    )


def init_pop_flags(desc: PopDesc, study_pop: str) -> np.ndarray:
    """Population selection flags for homogeneous analyses
    (reference: init_pop_flag_vec, src/gauss.cpp:1019-1066).

    ``study_pop`` may name a population OR a super-population.  Returns a
    0/1 int vector of length num_pops.  Raises on unknown names.
    """
    in_pop = study_pop in desc.pops
    in_sup = study_pop in desc.sup_pops
    if in_pop and not in_sup:
        ref = desc.pops
    elif in_sup and not in_pop:
        ref = desc.sup_pops
    elif not in_pop and not in_sup:
        raise ValueError(f"ERROR: invalid population name '{study_pop}'")
    else:
        # name appears in both lists: the reference leaves pop_vec empty and
        # selects nothing; surface that as an explicit error instead.
        raise ValueError(
            f"population name '{study_pop}' is both a population and a "
            "super-population in the panel description"
        )
    return np.array([1 if p == study_pop else 0 for p in ref], dtype=np.int8)


def init_pop_flag_wgts(desc: PopDesc, pop_wgt: Dict[str, float],
                       strict: bool = False):
    """Flags + aligned weights for cosmopolitan analyses
    (reference: init_pop_flag_wgt_vec, src/gauss.cpp:1093-1117).

    ``pop_wgt`` keys are upper-cased population abbreviations.  Returns
    (flags[num_pops] int8, weights[num_selected] float64) where weights
    follow panel population order restricted to flagged pops.

    Weight names absent from the panel are IGNORED by the reference
    (src/gauss.cpp:1093-1117 has no unknown-name branch -- e.g. 33KG
    afmix weights feed a 1KG panel without error; only the homogeneous
    study-pop reader aborts, src/gauss.cpp:1047-1050).  Default matches
    that but warns; ``strict=True`` upgrades unknown names to an error.
    """
    import warnings
    flags = np.zeros(desc.num_pops, dtype=np.int8)
    wgts: List[float] = []
    for i, p in enumerate(desc.pops):
        if p in pop_wgt:
            flags[i] = 1
            wgts.append(float(pop_wgt[p]))
    unknown = set(pop_wgt) - set(desc.pops)
    if unknown:
        msg = (f"population weight name(s) {sorted(unknown)} not in the "
               f"panel (pops: {list(desc.pops)})")
        if strict:
            raise ValueError("ERROR: invalid " + msg)
        warnings.warn(msg + "; ignored (reference semantics, "
                      "src/gauss.cpp:1093-1117)", RuntimeWarning)
    if not wgts:
        raise ValueError("ERROR: pop_wgt selects no panel populations")
    return flags, np.asarray(wgts, dtype=np.float64)


def pop_wgt_map_from_df(pop_wgt_df: pd.DataFrame) -> Dict[str, float]:
    """Population-weight map from a data frame.

    The reference reads columns positionally -- [0]=pop, [1]=weight,
    upper-cased (src/distmix.cpp:48-54) -- which breaks when fed the
    3-column afmix() output (sup.pop, pop, wgt).  We prefer columns
    NAMED pop/wgt (case-insensitive) when present so both the bundled
    2-column object and afmix output work, falling back to the
    reference's positional convention.
    """
    cols = [str(c).lower() for c in pop_wgt_df.columns]
    if "pop" in cols and "wgt" in cols:
        pcol = pop_wgt_df.columns[cols.index("pop")]
        wcol = pop_wgt_df.columns[cols.index("wgt")]
    else:
        pcol, wcol = pop_wgt_df.columns[0], pop_wgt_df.columns[1]
    pops = pop_wgt_df[pcol].astype(str).str.upper()
    wgts = pop_wgt_df[wcol].astype(float)
    return dict(zip(pops, wgts))


def read_annotation(path: str) -> pd.DataFrame:
    """Read SNP annotation (reference: ReadAnnotation,
    src/gauss.cpp:1275-1361).  Returns one row per (snp, category).

    DOCUMENTED DEVIATION: the reference's category mapping
    (src/gauss.cpp:1319-1330) has no else branch, so an unknown category
    string silently reuses the PREVIOUS row's categ_num -- an
    uninitialized-read bug, not a behavior worth reproducing.  We drop
    such rows with a warning instead of crashing (or corrupting)."""
    import warnings
    df = pd.read_csv(
        path,
        sep=r"\s+",
        header=None,
        skiprows=1,
        names=["rsid", "chr", "bp", "a1", "a2", "geneid", "categ", "wgt"],
        usecols=range(8),
        dtype={"rsid": str, "chr": np.int32, "bp": np.int64, "a1": str,
               "a2": str, "geneid": str, "categ": str, "wgt": np.float64},
    )
    df["categ_num"] = df["categ"].map(CATEG_NUM).astype("Int64")
    bad = df["categ_num"].isna()
    if bad.any():
        warnings.warn(
            f"annotation file has {int(bad.sum())} row(s) with unknown "
            f"category {sorted(df.loc[bad, 'categ'].unique())}; skipped "
            "(the reference would reuse the previous row's category, "
            "src/gauss.cpp:1319-1330)", RuntimeWarning)
        df = df[~bad].reset_index(drop=True)
    return df

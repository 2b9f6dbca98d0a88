"""Variant table and allele-aware panel join.

Struct-of-arrays replacement for the reference's ``std::map<MapKey,
Snp*>`` keyed by (chr, bp, a1, a2) with string-ordered alleles
(reference: src/gauss.h:72-106).  The join against the panel index
reproduces ReadReferenceIndex / ReadReferenceIndexAll semantics exactly
(reference: src/gauss.cpp:293-518):

* exact key match           -> type=1, take panel rsid + fpos
* swapped alleles (a2,a1)   -> flip z sign, adopt panel allele order,
                               type=1 (+ af1study -> 1-af1study in the
                               *All* and zmix variants)
* no match (non-All only)   -> insert panel SNP as type=0 unmeasured
* both orientations present -> "input file contains duplicates" error

SNP type codes (reference: src/snp.h:61,103):
    0 = unmeasured, exists in panel
    1 = measured, exists in panel
    2 = measured, absent from panel
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pandas as pd


class DuplicateInputError(ValueError):
    """Raised when the input contains both allele orientations of a panel SNP
    (reference: src/gauss.cpp:388-391)."""


def _key_frame(df: pd.DataFrame, a_first: str, a_second: str) -> pd.DataFrame:
    return pd.DataFrame({
        "chr": df["chr"].to_numpy(),
        "bp": df["bp"].to_numpy(),
        "ka1": df[a_first].to_numpy(),
        "ka2": df[a_second].to_numpy(),
    })


def sort_map_order(df: pd.DataFrame) -> pd.DataFrame:
    """Sort rows in MapKey order: (chr, bp, a1, a2) with bytewise string
    comparison on alleles (reference: MapKey::operator<, src/gauss.h:77-91).

    pandas compares python strings lexicographically by code point, which
    matches C++ std::string::operator< for ASCII allele strings.
    """
    return df.sort_values(["chr", "bp", "a1", "a2"], kind="stable").reset_index(drop=True)


def join_reference_index(
    input_df: pd.DataFrame,
    index_df: pd.DataFrame,
    add_unmeasured: bool,
    flip_af1study: bool = False,
) -> pd.DataFrame:
    """Allele-aware join of input GWAS rows against the panel index.

    Parameters
    ----------
    input_df: table from read_input_z / read_input_af with columns
        rsid chr bp a1 a2 [z] [af1study] info type.
    index_df: panel index table with columns rsid chr bp a1 a2 af1ref fpos.
    add_unmeasured: True for ReadReferenceIndex (dist/distmix/qcat
        pipelines), False for ReadReferenceIndexAll (afmix/jepeg).
    flip_af1study: the *All* and zmix index readers flip af1study on
        allele swap (reference: src/gauss.cpp:496); the windowed reader
        does not (src/gauss.cpp:358-370).

    Returns the merged variant table in MapKey order.
    """
    inp = input_df.reset_index(drop=True).copy()
    idx = index_df.reset_index(drop=True)

    # Build lookup of input keys in both orientations.
    ikey = pd.MultiIndex.from_arrays(
        [inp["chr"], inp["bp"], inp["a1"], inp["a2"]])
    ikey_map = pd.Series(np.arange(len(inp)), index=ikey)
    # panel keys, exact and swapped orientation
    pkey_exact = pd.MultiIndex.from_arrays(
        [idx["chr"], idx["bp"], idx["a1"], idx["a2"]])
    pkey_swap = pd.MultiIndex.from_arrays(
        [idx["chr"], idx["bp"], idx["a2"], idx["a1"]])

    hit_exact = ikey_map.reindex(pkey_exact).to_numpy()   # input row id or NaN
    hit_swap = ikey_map.reindex(pkey_swap).to_numpy()

    both = ~np.isnan(hit_exact) & ~np.isnan(hit_swap)
    if both.any():
        raise DuplicateInputError("ERROR: input file contains duplicates")

    n_inp = len(inp)
    rsid = inp["rsid"].to_numpy(dtype=object).copy()
    a1 = inp["a1"].to_numpy(dtype=object).copy()
    a2 = inp["a2"].to_numpy(dtype=object).copy()
    z = (inp["z"].to_numpy(dtype=np.float64).copy()
         if "z" in inp else np.zeros(n_inp))
    af1study = (inp["af1study"].to_numpy(dtype=np.float64).copy()
                if "af1study" in inp else np.full(n_inp, np.nan))
    snp_type = np.full(n_inp, 2, dtype=np.int8)
    fpos = np.full(n_inp, -1, dtype=np.int64)
    af1ref = np.full(n_inp, np.nan, dtype=np.float64)

    # Exact matches: later panel rows overwrite earlier ones, like repeated
    # std::map updates in the sequential reference loop.
    em = ~np.isnan(hit_exact)
    if em.any():
        rows = hit_exact[em].astype(np.int64)
        prsid = idx["rsid"].to_numpy(dtype=object)[em]
        pfpos = idx["fpos"].to_numpy(dtype=np.int64)[em]
        pafref = idx["af1ref"].to_numpy(dtype=np.float64)[em]
        rsid[rows] = prsid
        snp_type[rows] = 1
        fpos[rows] = pfpos
        af1ref[rows] = pafref

    sm = ~np.isnan(hit_swap)
    if sm.any():
        rows = hit_swap[sm].astype(np.int64)
        rsid[rows] = idx["rsid"].to_numpy(dtype=object)[sm]
        a1[rows] = idx["a1"].to_numpy(dtype=object)[sm]
        a2[rows] = idx["a2"].to_numpy(dtype=object)[sm]
        z[rows] = -z[rows]
        snp_type[rows] = 1
        fpos[rows] = idx["fpos"].to_numpy(dtype=np.int64)[sm]
        af1ref[rows] = idx["af1ref"].to_numpy(dtype=np.float64)[sm]
        if flip_af1study:
            af1study[rows] = 1.0 - af1study[rows]

    out = pd.DataFrame({
        "rsid": rsid, "chr": inp["chr"].to_numpy(), "bp": inp["bp"].to_numpy(),
        "a1": a1, "a2": a2, "z": z, "af1study": af1study,
        "af1ref": af1ref, "fpos": fpos, "type": snp_type,
        "info": inp["info"].to_numpy() if "info" in inp else np.ones(n_inp),
    })

    if add_unmeasured:
        un = ~em & ~sm
        if un.any():
            add = pd.DataFrame({
                "rsid": idx["rsid"].to_numpy(dtype=object)[un],
                "chr": idx["chr"].to_numpy()[un],
                "bp": idx["bp"].to_numpy()[un],
                "a1": idx["a1"].to_numpy(dtype=object)[un],
                "a2": idx["a2"].to_numpy(dtype=object)[un],
                "z": 0.0,
                "af1study": np.nan,
                "af1ref": idx["af1ref"].to_numpy(dtype=np.float64)[un],
                "fpos": idx["fpos"].to_numpy(dtype=np.int64)[un],
                "type": np.int8(0),
                "info": 0.0,
            })
            # duplicate panel keys keep the last (map overwrite)
            add = add.drop_duplicates(subset=["chr", "bp", "a1", "a2"], keep="last")
            out = pd.concat([out, add], ignore_index=True)

    return sort_map_order(out)


def join_annotation(
    table: pd.DataFrame,
    annot_df: pd.DataFrame,
) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Apply annotation to a variant table (reference: ReadAnnotation,
    src/gauss.cpp:1275-1361).

    On swapped-allele annotation matches the reference flips af1ref and z
    and adopts the annotation allele order.  Multiple categories per SNP
    accumulate in a categ map; the table gains a ``geneid`` column and a
    separate (row_id, categ_num, wgt) long-format frame is returned.

    NOTE the reference applies the swap mutation once per matching
    annotation LINE; a SNP with two annotation rows in swapped orientation
    would be double-flipped.  Real annotation files list each SNP in one
    orientation, and we flip at most once per SNP (documented deviation
    from that pathological case).
    """
    tab = table.reset_index(drop=True).copy()
    key = pd.MultiIndex.from_arrays([tab["chr"], tab["bp"], tab["a1"], tab["a2"]])
    key_map = pd.Series(np.arange(len(tab)), index=key)

    akey_exact = pd.MultiIndex.from_arrays(
        [annot_df["chr"], annot_df["bp"], annot_df["a1"], annot_df["a2"]])
    akey_swap = pd.MultiIndex.from_arrays(
        [annot_df["chr"], annot_df["bp"], annot_df["a2"], annot_df["a1"]])
    hit_exact = key_map.reindex(akey_exact).to_numpy()
    hit_swap = key_map.reindex(akey_swap).to_numpy()

    geneid = np.full(len(tab), ".", dtype=object)
    cat_rows = []

    em = ~np.isnan(hit_exact)
    rows = hit_exact[em].astype(np.int64)
    geneid[rows] = annot_df["geneid"].to_numpy(dtype=object)[em]
    cat_rows.append(pd.DataFrame({
        "row": rows,
        "categ": annot_df["categ_num"].to_numpy()[em],
        "wgt": annot_df["wgt"].to_numpy()[em],
    }))

    # swapped-orientation matches: only annotation rows with NO exact hit
    sm = ~np.isnan(hit_swap) & np.isnan(hit_exact)
    if sm.any():
        rows = hit_swap[sm].astype(np.int64)
        urows, first_pos = np.unique(rows, return_index=True)
        # flip once per SNP
        tab.loc[urows, "af1ref"] = 1.0 - tab.loc[urows, "af1ref"].to_numpy()
        tab.loc[urows, "z"] = -tab.loc[urows, "z"].to_numpy()
        tab.loc[urows, "a1"] = annot_df["a1"].to_numpy(dtype=object)[sm][first_pos]
        tab.loc[urows, "a2"] = annot_df["a2"].to_numpy(dtype=object)[sm][first_pos]
        geneid[rows] = annot_df["geneid"].to_numpy(dtype=object)[sm]
        cat_rows.append(pd.DataFrame({
            "row": rows,
            "categ": annot_df["categ_num"].to_numpy()[sm],
            "wgt": annot_df["wgt"].to_numpy()[sm],
        }))

    tab["geneid"] = geneid
    categs = (pd.concat(cat_rows, ignore_index=True)
              if cat_rows else pd.DataFrame(columns=["row", "categ", "wgt"]))
    # categ map semantics: later rows overwrite same (snp, categ)
    categs = categs.drop_duplicates(subset=["row", "categ"], keep="last")
    return tab, categs

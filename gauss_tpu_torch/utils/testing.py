"""Synthetic panel + GWAS fixture generator.

The reference ships no automated tests (SURVEY.md section 4); this
module creates small reference-format panels with controllable LD and
population structure so every layer (bgzf decode, allele join, AF
filters, LD kernels, imputation) is unit-testable without the 33KG
download.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pandas as pd

from ..io.bgzf import BgzfWriter
from ..io.panel import write_panel
from ..io.readers import PopDesc
from ..config import PanelFiles


@dataclasses.dataclass
class SyntheticPanel:
    files: PanelFiles
    desc: PopDesc
    index_df: pd.DataFrame
    genotypes: np.ndarray   # int8 [n_snps, total_subjects]
    afs: np.ndarray         # float64 [n_snps, num_pops] (written panel AFs)


def _simulate_genotypes(rng: np.random.Generator, n_snps: int,
                        pop_sizes: Sequence[int], rho: float = 0.92,
                        af_low: float = 0.05, af_high: float = 0.95,
                        pop_af_jitter: float = 0.12) -> Tuple[np.ndarray, np.ndarray]:
    """AR(1)-correlated haplotypes -> genotypes with LD decaying along the
    SNP axis and per-population allele-frequency divergence."""
    base_af = rng.uniform(af_low, af_high, size=n_snps)
    G_pops = []
    target_afs = []
    for m in pop_sizes:
        af = np.clip(base_af + rng.normal(0, pop_af_jitter, size=n_snps),
                     0.02, 0.98)
        target_afs.append(af)
        thresh = _norm_ppf(af)
        hap = np.empty((2 * m, n_snps))
        x = rng.standard_normal(2 * m)
        for i in range(n_snps):
            x = rho * x + np.sqrt(1 - rho * rho) * rng.standard_normal(2 * m)
            hap[:, i] = x
        alleles = (hap < thresh[None, :]).astype(np.int8)
        G_pops.append(alleles[0::2] + alleles[1::2])  # [m, n_snps]
    G = np.concatenate(G_pops, axis=0).T.astype(np.int8)  # [n_snps, S]
    return G, np.stack(target_afs, axis=1)


def _norm_ppf(p: np.ndarray) -> np.ndarray:
    from scipy.special import ndtri
    return ndtri(p)


DEFAULT_POPS = [
    ("AAA", 40, "EUR"), ("BBB", 55, "EUR"), ("CCC", 35, "EAS"),
    ("DDD", 50, "EAS"), ("EEE", 45, "AFR"),
]


def make_synthetic_panel(
    out_dir: str,
    n_snps: int = 300,
    pops: Optional[List[Tuple[str, int, str]]] = None,
    chrom: int = 22,
    bp_start: int = 1_000_000,
    bp_step: int = 1_000,
    seed: int = 7,
    prefix: str = "synpanel",
) -> SyntheticPanel:
    """Write a reference-format panel (index/data/pop-desc) to out_dir."""
    pops = pops if pops is not None else DEFAULT_POPS
    rng = np.random.default_rng(seed)
    desc = PopDesc(
        pops=[p[0] for p in pops],
        sizes=np.array([p[1] for p in pops], dtype=np.int64),
        sup_pops=[p[2] for p in pops],
    )
    G, _ = _simulate_genotypes(rng, n_snps, desc.sizes)

    alleles = np.array(["A", "C", "G", "T"])
    a1 = alleles[rng.integers(0, 4, n_snps)]
    a2_choices = alleles[rng.integers(0, 3, n_snps)]
    a2 = np.where(a2_choices == a1, "T", a2_choices)
    a2 = np.where(a2 == a1, "G", a2)  # guarantee a1 != a2
    index_df = pd.DataFrame({
        "rsid": [f"rs{100000 + i}" for i in range(n_snps)],
        "chr": np.full(n_snps, chrom, dtype=np.int32),
        "bp": bp_start + bp_step * np.arange(n_snps, dtype=np.int64),
        "a1": a1,
        "a2": a2,
    })

    os.makedirs(out_dir, exist_ok=True)
    idx_f, dat_f, pd_f = write_panel(os.path.join(out_dir, prefix),
                                     desc, index_df, G)
    # written AFs = per-pop genotype means / 2 (computed by write_panel)
    bounds = np.concatenate([[0], np.cumsum(desc.sizes)])
    afs = np.stack([G[:, bounds[k]:bounds[k + 1]].mean(axis=1) / 2.0
                    for k in range(desc.num_pops)], axis=1)
    return SyntheticPanel(
        files=PanelFiles(idx_f, dat_f, pd_f),
        desc=desc,
        index_df=index_df,
        genotypes=G,
        afs=afs,
    )


def make_gwas_input(
    panel: SyntheticPanel,
    out_path: str,
    measured_frac: float = 0.6,
    swap_frac: float = 0.15,
    n_extra: int = 5,
    seed: int = 11,
) -> pd.DataFrame:
    """Write a Z-score input file referencing the synthetic panel.

    A random subset of panel SNPs is 'measured'; of those, ``swap_frac``
    are written with swapped alleles and negated z (exercising the
    allele-flip join, reference src/gauss.cpp:358-370); ``n_extra`` SNPs
    not present in the panel are appended (type 2).

    Returns the TRUE (panel-orientation) z table for checking.
    """
    rng = np.random.default_rng(seed)
    n = len(panel.index_df)
    measured = np.sort(rng.choice(n, size=int(n * measured_frac), replace=False))
    z_true = rng.standard_normal(len(measured)) * 1.5

    rows = []
    truth = []
    for j, i in enumerate(measured):
        r = panel.index_df.iloc[i]
        swap = rng.random() < swap_frac
        if swap:
            rows.append((r.rsid + "x", r.chr, r.bp, r.a2, r.a1, -z_true[j]))
        else:
            rows.append((r.rsid + "x", r.chr, r.bp, r.a1, r.a2, z_true[j]))
        truth.append((r.rsid, r.chr, r.bp, r.a1, r.a2, z_true[j]))
    # extra SNPs absent from the panel
    for e in range(n_extra):
        bp = int(panel.index_df["bp"].max()) + 1000 * (e + 1)
        rows.append((f"rsX{e}", int(panel.index_df["chr"].iloc[0]), bp,
                     "A", "G", float(rng.standard_normal())))

    with open(out_path, "w") as fh:
        fh.write("rsid chr bp a1 a2 z\n")
        for r in rows:
            fh.write(" ".join(str(x) for x in r) + "\n")

    return pd.DataFrame(truth, columns=["rsid", "chr", "bp", "a1", "a2", "z"])


def make_annotation(
    panel: SyntheticPanel,
    out_path: str,
    n_genes: int = 6,
    snps_per_gene: int = 8,
    swap_frac: float = 0.2,
    seed: int = 23,
) -> pd.DataFrame:
    """Write an annotation file (rsid chr bp a1 a2 geneid categ wgt)
    assigning consecutive panel SNPs to genes; some rows use swapped
    alleles to exercise the annotation flip (reference:
    src/gauss.cpp:1339-1355).  SNPs may carry 1-2 categories."""
    from ..io.readers import CATEG_NUM
    rng = np.random.default_rng(seed)
    categ_names = list(CATEG_NUM)
    rows = []
    stride = max(1, len(panel.index_df) // (n_genes * snps_per_gene + 5))
    i = 0
    for g in range(n_genes):
        gene = f"GENE{g:02d}"
        for s in range(snps_per_gene):
            r = panel.index_df.iloc[i]
            swap = rng.random() < swap_frac
            a1, a2 = (r.a2, r.a1) if swap else (r.a1, r.a2)
            n_cat = 1 + (rng.random() < 0.3)
            for c in rng.choice(len(categ_names), size=n_cat, replace=False):
                rows.append((r.rsid, r.chr, r.bp, a1, a2, gene,
                             categ_names[c], round(rng.uniform(0.2, 2.0), 3)))
            i += stride
    df = pd.DataFrame(rows, columns=["rsid", "chr", "bp", "a1", "a2",
                                     "geneid", "categ", "wgt"])
    with open(out_path, "w") as fh:
        fh.write("rsid chr bp a1 a2 geneid categ wgt\n")
        for r in df.itertuples(index=False):
            fh.write(" ".join(str(x) for x in r) + "\n")
    return df


def make_af_input(
    panel: SyntheticPanel,
    out_path: str,
    pop_mix: Optional[dict] = None,
    measured_frac: float = 0.9,
    seed: int = 13,
) -> pd.DataFrame:
    """Write an AF input file whose study AFs are a known mixture of the
    panel population AFs (ground truth for afmix/cpw2 tests)."""
    rng = np.random.default_rng(seed)
    desc = panel.desc
    if pop_mix is None:
        w = rng.dirichlet(np.ones(desc.num_pops))
        pop_mix = dict(zip(desc.pops, w))
    wvec = np.array([pop_mix.get(p, 0.0) for p in desc.pops])
    af_study = panel.afs @ wvec + rng.normal(0, 0.005, len(panel.index_df))
    af_study = np.clip(af_study, 0.001, 0.999)

    n = len(panel.index_df)
    measured = np.sort(rng.choice(n, size=int(n * measured_frac), replace=False))
    with open(out_path, "w") as fh:
        fh.write("rsid chr bp a1 a2 af1\n")
        for i in measured:
            r = panel.index_df.iloc[i]
            fh.write(f"{r.rsid} {r.chr} {r.bp} {r.a1} {r.a2} {af_study[i]:.6f}\n")
    return pd.DataFrame({"pop": list(pop_mix), "wgt": [pop_mix[p] for p in pop_mix]})

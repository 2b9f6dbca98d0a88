"""Golden regression oracles from the reference's executed vignettes.

The reference ships no automated tests; its only regression oracles are
the executed pkgdown outputs under ``docs/articles/*.md`` (SURVEY.md
section 4).  This module pins those published numbers together with the
exact calls that produced them, so a parity run against the real 33KG
panel (29 pops, 32,953 subjects -- not bundled; distributed
out-of-band, vignettes/ref_33KG.Rmd:17-21) can be executed the moment
the panel is available:

    GAUSS_33KG_DIR=/path/to/33KG python -m pytest tests/test_goldens_33kg.py

The directory must contain the reference's published file names:
``33kg_index.gz``, ``33kg_geno.gz``, ``33kg_pop_desc.txt``
(docs/articles/dist_example.md:82-84).
"""

from __future__ import annotations

import os
from typing import Optional

#: reference bundled inputs (docs/articles/dist_example.md:58)
PGC2_3MB = "data/PGC2_3Mb.txt"
PGC2_CHR22_Z = "data/PGC2_Chr22_ilmn1M_Z.txt"
PGC2_CHR22_AF = "data/PGC2_Chr22_ilmn1M_AF1.txt"

#: vignette window (docs/articles/dist_example.md:144-148)
DIST_CALL = dict(chrom=10, start_bp=104_000_001, end_bp=105_000_000,
                 wing_size=500_000, study_pop="EUR")
DISTMIX_CALL = dict(chrom=10, start_bp=104_000_001, end_bp=105_000_000,
                    wing_size=500_000)  # pop_wgt_df = PGC2_SCZ_ANC_Prop
COMPUTELD_CALL = dict(chrom=10, start_bp=104_000_001, end_bp=105_000_000,
                      af1_cutoff=0.001)

#: head rows of dist() output (docs/articles/dist_example.md:163-170);
#: (rsid, af1ref, z, info)
DIST_GOLD = [
    ("rs117589665", 0.05720, 3.7785313, 0.9498775),
    ("rs530689457", 0.00336, -1.2757191, 0.0831094),
    ("rs9664049", 0.61243, -0.4576290, 0.9859440),
    ("rs149691625", 0.00351, -2.9077590, 0.0870822),
    ("rs112009583", 0.01793, 0.6621509, 0.9589020),
    ("rs35200058", 0.00575, 1.4120431, 0.1878804),
]

#: head rows of distmix() output (docs/articles/dist_example.md:267-274);
#: (rsid, af1mix, z, info)
DISTMIX_GOLD = [
    ("rs117589665", 0.0498071, 3.7654380, 0.9502816),
    ("rs530689457", 0.0025437, -1.5946817, 0.1066791),
    ("rs74469897", 0.0019094, -0.3681266, 0.0353468),
    ("rs115917085", 0.0017765, -0.5970168, 0.0405042),
    ("rs9664049", 0.6636273, -0.4611119, 0.9857299),
    ("rs149691625", 0.0046659, -2.7223779, 0.0791714),
]

#: computeLD snplist head (docs/articles/computeLD_example.md:164-171)
COMPUTELD_SNPLIST_GOLD = [
    ("rs3758549", 0.1928059), ("rs1541046", 0.6625196),
    ("rs2296887", 0.1591055), ("rs10748818", 0.1664600),
    ("rs1628530", 0.1235526), ("rs17114433", 0.0247393),
]
#: cormat upper-left corner (docs/articles/computeLD_example.md:178-180)
COMPUTELD_CORMAT_GOLD = [
    [1.0000000, 0.3862754, -0.2043553],
    [0.3862754, 1.0000000, 0.3080552],
    [-0.2043553, 0.3080552, 1.0000000],
]

#: afmix weights on PGC2 chr22 AFs (docs/articles/afmix_example.md
#: results table) -- same values as data.PGC2_SCZ_ANC_Prop
AFMIX_GOLD = {
    "ACB": 0.006, "ASW": 0.036, "BEB": 0.005, "CCE": 0.008, "CCS": 0.004,
    "CDX": 0.018, "CEU": 0.165, "CLM": 0.025, "CNE": 0.003, "CSE": 0.012,
    "FIN": 0.138, "GBR": 0.165, "GIH": 0.006, "IBS": 0.099, "JPT": 0.011,
    "KHV": 0.017, "MXL": 0.030, "ORK": 0.166, "PJL": 0.016, "PUR": 0.045,
    "TSI": 0.086,
}

#: jepeg top genes (docs/articles/jepeg_example.md:173-180);
#: (geneid, chisq, df, top_categ, top_snp)
JEPEG_GOLD = [
    ("DPYD", 38.41841, 1, "TRN", "rs3788568"),
    ("CXCL14", 33.98061, 1, "TRN", "rs133047"),
    ("EP300", 29.29304, 1, "PFS", "rs20551"),
    ("WBP2NL", 24.71184, 1, "PFS", "rs2301521"),
    ("NDUFA6", 24.39774, 1, "PFS", "rs1801311"),
    ("ZBED4", 19.38566, 1, "PFS", "rs910799"),
]
#: jepegmix differences (docs/articles/jepeg_example.md:269-274)
JEPEGMIX_GOLD = [
    ("DPYD", 38.41841, 1, "TRN", "rs3788568"),
    ("CXCL14", 33.81352, 1, "TRN", "rs133047"),
    ("EP300", 29.29304, 1, "PFS", "rs20551"),
    ("WBP2NL", 24.71140, 1, "PFS", "rs2301521"),
    ("NDUFA6", 24.39774, 1, "PFS", "rs1801311"),
    ("ZBED4", 19.38566, 1, "PFS", "rs910799"),
]


def panel_dir() -> Optional[str]:
    """33KG panel directory from the environment, or None."""
    d = os.environ.get("GAUSS_33KG_DIR")
    if d and os.path.isfile(os.path.join(d, "33kg_index.gz")):
        return d
    return None


def reference_dir() -> Optional[str]:
    """Mirror of the reference repo (for its bundled data fixtures), from
    the environment, or None."""
    d = os.environ.get("GAUSS_REFERENCE_DIR")
    if d and os.path.isfile(os.path.join(d, PGC2_3MB)):
        return d
    return None

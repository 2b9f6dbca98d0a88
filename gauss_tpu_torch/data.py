"""Bundled data, mirroring the reference package's ``data/`` payloads.

The reference ships ``PGC2_SCZ_ANC_Prop`` (R/PGC2_SCZ_ANC_Prop.R:1-26,
data/PGC2_SCZ_ANC_Prop.RData): the 21-row population-weight data frame
produced by running afmix on the PGC2 schizophrenia chr22 allele
frequencies against the 33KG panel.  The values below are the published
result table (docs/articles/afmix_example.md, "Results: Estimated
Ancestry Proportions"), and feed the ``pop_wgt_df`` argument of
distmix/computeLD/jepegmix/qcatmix exactly like the reference's bundled
object does (vignettes/dist_example.Rmd:182-190).
"""

from __future__ import annotations

import pandas as pd

_PGC2_ROWS = [
    ("ACB", 0.006), ("ASW", 0.036), ("BEB", 0.005), ("CCE", 0.008),
    ("CCS", 0.004), ("CDX", 0.018), ("CEU", 0.165), ("CLM", 0.025),
    ("CNE", 0.003), ("CSE", 0.012), ("FIN", 0.138), ("GBR", 0.165),
    ("GIH", 0.006), ("IBS", 0.099), ("JPT", 0.011), ("KHV", 0.017),
    ("MXL", 0.030), ("ORK", 0.166), ("PJL", 0.016), ("PUR", 0.045),
    ("TSI", 0.086),
]


def pgc2_scz_anc_prop() -> pd.DataFrame:
    """PGC2 schizophrenia ancestry proportions (33KG, chr22 AFs).

    Two columns (pop, wgt) like the reference's R object
    (R/PGC2_SCZ_ANC_Prop.R: "two columns ... pop ... wgt"); the afmix()
    OUTPUT additionally carries sup.pop (docs/articles/afmix_example.md)
    and is also accepted anywhere a pop_wgt_df is expected.
    """
    return pd.DataFrame(_PGC2_ROWS, columns=["pop", "wgt"])


#: module-level constant matching the reference object's name
PGC2_SCZ_ANC_Prop = pgc2_scz_anc_prop()

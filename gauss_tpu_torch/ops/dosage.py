"""Genotype dosage recodings (elementwise device-trivial ops).

Reference equivalents operate on '0'/'1'/'2' character strings:
* minor-allele flip g -> 2-g (reference: UpdateSnpToMinorAllele,
  src/gauss.cpp:1137-1184)
* additive -> dominant: 1,2 -> 1 (ConvertGenotypesToDominant,
  src/gauss.cpp:1196-1216)
* additive -> recessive: 2 -> 1 else 0 (ConvertGenotypesToRecessive,
  src/gauss.cpp:1228-1250)
"""

from __future__ import annotations

import numpy as np


def flip_dosage(G: np.ndarray) -> np.ndarray:
    """g -> 2 - g."""
    return (2 - G.astype(np.int16)).astype(G.dtype)


def to_dominant(G: np.ndarray) -> np.ndarray:
    return (G > 0).astype(G.dtype)


def to_recessive(G: np.ndarray) -> np.ndarray:
    return (G == 2).astype(G.dtype)


def minor_allele_update(G: np.ndarray, af: np.ndarray, z: np.ndarray,
                        a1: np.ndarray, a2: np.ndarray):
    """Apply the minor-allele normalization to rows with af > 0.5:
    af -> 1-af, z -> -z, swap alleles, g -> 2-g.  Returns new arrays
    (inputs are not modified)."""
    flip = af > 0.5
    G2 = G.copy()
    G2[flip] = flip_dosage(G[flip])
    af2 = np.where(flip, 1.0 - af, af)
    z2 = np.where(flip, -z, z)
    a1_2 = np.where(flip, a2, a1)
    a2_2 = np.where(flip, a1, a2)
    return G2, af2, z2, a1_2, a2_2, flip

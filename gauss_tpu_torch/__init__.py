"""gauss_tpu_torch: the GWAS summary-statistics engine in PyTorch/CUDA.

A port of the JAX package ``gauss_tpu`` (which stays the reference).
Ported so far:

* the per-call float64 API: dist, distmix, compute_ld (computeLD),
  simulate_ld (simulateLD), and lazily qcat, qcatmix, prep_qcat and
  prep_recessive_impute;
* the genome engine (``models.genome.GenomeEngine``): the decoded panel
  store, the float64 host parity path, and the resident region kernels
  for imputation (impute_region), LD (ld_window / ld_region) and qcat
  (qcat_region), whose Gram (K1, ``ops/gram.py``) and row gather (K2,
  ``ops/gather.py``) are CUDA kernels for sm_90a, built from ``csrc/``
  on first use.  CPU tensors run the kernels' plain PyTorch versions.

Importing the package has no side effects: nothing is built, no device
is touched.
"""

from .config import PanelFiles, Settings
from .models.dist import dist, distmix
from .models.ld import compute_ld, simulate_ld

# reference-style aliases
computeLD = compute_ld
simulateLD = simulate_ld

__version__ = "0.1.0"

__all__ = [
    "Settings", "PanelFiles",
    "dist", "distmix",
    "compute_ld", "simulate_ld", "computeLD", "simulateLD",
]


def __getattr__(name):
    """Lazy exports for the wider API surface (keeps import light)."""
    lazy = {n: ("gauss_tpu_torch.models.qcat", n) for n in (
        "qcat", "qcatmix", "prep_qcat", "prep_recessive_impute")}
    if name in lazy:
        import importlib
        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'gauss_tpu_torch' has no attribute "
                         f"'{name}'")

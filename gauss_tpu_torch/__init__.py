"""gauss_tpu_torch: the GWAS summary-statistics engine in PyTorch/CUDA.

A port of the JAX package ``gauss_tpu`` (which stays the reference).
This slice covers distmix/dist region imputation: the decoded panel
store, the float64 host parity path, and the resident region kernel
whose Gram (K1, ``ops/gram.py``) and row gather (K2, ``ops/gather.py``)
are CUDA kernels for sm_90a, built from ``csrc/`` on first use.  CPU
tensors run the kernels' plain PyTorch versions.

Importing the package has no side effects: nothing is built, no device
is touched.  ``models.genome.GenomeEngine`` is the entry point.
"""

__version__ = "0.1.0"

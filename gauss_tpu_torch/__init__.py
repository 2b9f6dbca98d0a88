"""gauss_tpu_torch: the GWAS summary-statistics engine in PyTorch/CUDA.

A port of the JAX package ``gauss_tpu`` (which stays the reference).
Ported so far:

* the per-call float64 API: dist, distmix, compute_ld (computeLD),
  simulate_ld (simulateLD), and lazily qcat, qcatmix, prep_qcat,
  prep_recessive_impute, jepeg, jepegmix, the ancestry family (afmix,
  cpw2, prep_zmix .. prep_zmix5_sup, zmix), fiqt and the bundled
  PGC2_SCZ_ANC_Prop weights;
* the genome engine (``models.genome.GenomeEngine``): the decoded panel
  store, the float64 host parity path, and the resident region kernels
  for imputation (impute_region), LD (ld_window / ld_region) and qcat
  (qcat_region), gene tests (prepare_genes -> jepeg_region) and
  ancestry over the store, whose Gram (K1, ``ops/gram.py``) and row
  gather (K2, ``ops/gather.py``) are CUDA kernels for sm_90a, built from
  ``csrc/`` on first use.  CPU tensors run the kernels' plain PyTorch
  versions;
* the single-window device path: ``PreparedRun.impute_window`` with the
  engine's ``device_linalg`` runs the window as a one-window region
  through the resident kernel (the float64 host window otherwise);
* the checkpointed genome runner (``models.runner.GenomeRunner``:
  ``manifest.json`` ledger, one parquet shard per chunk, resume and
  restart, the analyses impute / qcat / ld / jepeg, resident and
  streaming panels, one chunk at a time) and its phase tracer
  (``utils.timing``:
  ``Tracer``, ``device_trace`` on torch.profiler);
* the device mesh (``parallel.mesh``, ``make_mesh``): a (window x
  subject) grid of devices one process drives, ``GenomeEngine(store,
  mesh=...)`` running every device path with the panel split into
  subject shards (K2 and K1 per shard) and the windows or genes split
  over window groups, and zmix's pair statistics; multi-host runs
  (``parallel.distributed``): one process per host under torchrun, each
  with its own window range and ledger, meeting at a barrier and the
  result shards;
* the command line (``cli.py``, ``python -m gauss_tpu_torch <cmd>``):
  gauss_tpu's subcommands and arguments, plus ``--device`` (default
  ``cuda``) on impute-region, qcat-region, impute-genome and zmix,
  ``--mesh WxS`` and ``impute-genome --multihost``;
  ``entry.entry(device)``, the resident kernel on a toy batch,
  ``entry.dryrun_multichip(n, device)``, the mesh paths against one
  device, and ``utils.goldens``;
* probe 7 (``probes/probe7_int4.py``): an int4 product (K3) and row sums
  over a block resident in a cluster's shared memory (K4).

Importing the package has no side effects: nothing is built, no device
is touched, no process-wide switch is set (the resident kernels turn
TF32 off around their own matmuls and restore it).
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
    lazy = {n: ("gauss_tpu_torch.models.ancestry", n) for n in (
        "afmix", "cpw2", "zmix", "prep_zmix", "prep_zmix2", "prep_zmix3",
        "prep_zmix4", "prep_zmix5", "prep_zmix5_sup")}
    lazy.update({n: ("gauss_tpu_torch.models.qcat", n) for n in (
        "qcat", "qcatmix", "prep_qcat", "prep_recessive_impute")})
    lazy.update({"jepeg": ("gauss_tpu_torch.models.jepeg", "jepeg"),
                 "jepegmix": ("gauss_tpu_torch.models.jepeg", "jepegmix"),
                 "fiqt": ("gauss_tpu_torch.models.fiqt", "fiqt"),
                 "PGC2_SCZ_ANC_Prop": ("gauss_tpu_torch.data",
                                       "PGC2_SCZ_ANC_Prop"),
                 "pgc2_scz_anc_prop": ("gauss_tpu_torch.data",
                                       "pgc2_scz_anc_prop"),
                 "make_mesh": ("gauss_tpu_torch.parallel.mesh",
                               "make_mesh")})
    if name == "parallel":
        import importlib
        return importlib.import_module("gauss_tpu_torch.parallel")
    if name in lazy:
        import importlib
        mod, attr = lazy[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'gauss_tpu_torch' has no attribute "
                         f"'{name}'")

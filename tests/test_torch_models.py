"""The per-call float64 API of gauss_tpu_torch (dist, distmix,
compute_ld, simulate_ld and the qcat family) and the host layer under it
(core/ldkernels, core/linalg, models/pipeline, ops/dosage) against
gauss_tpu's on the same panel and inputs.

Tolerance: rtol 1e-10 (atol 1e-12) everywhere.  Both sides take exact
integer statistics in float32 and combine them in float64 in the same
order; what remains is LAPACK rounding of float64 eigen/inverse/solve
routines called through numpy/scipy on one side and torch on the other,
~1e-14 relative for these well-conditioned ridge matrices."""

import warnings

import numpy as np
import pandas as pd
import pytest
import torch

import gauss_tpu
import gauss_tpu_torch
from gauss_tpu.config import PanelFiles as JFiles
from gauss_tpu.core import ldkernels as j_ld
from gauss_tpu.core import linalg as j_linalg
from gauss_tpu.io import readers as j_readers
from gauss_tpu.models import pipeline as j_pipeline
from gauss_tpu.ops import dosage as j_dosage
from gauss_tpu_torch.config import PanelFiles as TFiles
from gauss_tpu_torch.core import ldkernels as t_ld
from gauss_tpu_torch.core import linalg as t_linalg
from gauss_tpu_torch.models import pipeline as t_pipeline
from gauss_tpu_torch.ops import dosage as t_dosage

RTOL, ATOL = 1e-10, 1e-12
POP_WGT = pd.DataFrame({"pop": ["AAA", "BBB", "EEE"],
                        "wgt": [0.4, 0.35, 0.25]})
STUDY_POP = "EUR"     # a super-population over two panel segments


@pytest.fixture(scope="module")
def args(synpanel, gwas_input):
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    files = (path, synpanel.files.index_file, synpanel.files.data_file,
             synpanel.files.pop_desc_file)
    return dict(lo=lo, hi=hi, p_lo=lo + (hi - lo) // 3,
                p_hi=lo + 2 * (hi - lo) // 3, wing=(hi - lo) // 3,
                files=files)


def _call(pkg, name, a):
    """Call ``name`` of package ``pkg`` as a user would, with the
    function's own default af1_cutoff."""
    fn = getattr(pkg, name)
    f = a["files"]
    if name in ("compute_ld", "computeLD"):
        return fn(22, a["lo"], a["hi"], POP_WGT, *f)
    pops = STUDY_POP if name in ("dist", "qcat", "prep_qcat") else POP_WGT
    return fn(22, a["p_lo"], a["p_hi"], a["wing"], pops, *f)


def _assert_same(got, ref):
    if isinstance(ref, pd.DataFrame):
        assert list(got.columns) == list(ref.columns) and len(ref) > 0
        for col in ref.columns:
            a, b = got[col].to_numpy(), ref[col].to_numpy()
            if b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
            else:
                assert a.dtype == b.dtype, col
                np.testing.assert_array_equal(a, b)
    elif isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _assert_same(got[k], ref[k])
    else:
        assert np.asarray(got).shape == np.asarray(ref).shape
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", [
    "dist", "distmix", "compute_ld", "qcat", "qcatmix", "prep_qcat",
    "prep_recessive_impute"])
def test_per_call_api_matches_jax(args, name):
    _assert_same(_call(gauss_tpu_torch, name, args),
                 _call(gauss_tpu, name, args))


def test_simulate_ld_identical_for_a_seed(args):
    f = args["files"]
    call = (22, args["lo"], args["hi"], POP_WGT, 400, *f)
    a = gauss_tpu.simulate_ld(*call, seed=7)
    b = gauss_tpu_torch.simulateLD(*call, seed=7)
    pd.testing.assert_frame_equal(b["snplist"], a["snplist"])
    np.testing.assert_array_equal(b["cormat"], a["cormat"])


def test_exports():
    assert gauss_tpu_torch.computeLD is gauss_tpu_torch.compute_ld
    assert gauss_tpu_torch.simulateLD is gauss_tpu_torch.simulate_ld
    for name in ("qcat", "qcatmix", "prep_qcat", "prep_recessive_impute",
                 "jepeg", "jepegmix", "afmix", "cpw2", "zmix", "prep_zmix",
                 "prep_zmix2", "prep_zmix3", "prep_zmix4", "prep_zmix5",
                 "prep_zmix5_sup", "fiqt", "pgc2_scz_anc_prop"):
        assert callable(getattr(gauss_tpu_torch, name))
        assert callable(getattr(gauss_tpu, name))
    assert isinstance(gauss_tpu_torch.PGC2_SCZ_ANC_Prop, pd.DataFrame)
    with pytest.raises(AttributeError):
        gauss_tpu_torch.GenomeRunner     # as in gauss_tpu: not a package
                                         # export (models.runner has it)


@pytest.fixture(scope="module")
def window(synpanel, gwas_input):
    """One loaded window through both packages' pipeline."""
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    inp = j_readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                                 wing_size=0)
    f = (synpanel.files.index_file, synpanel.files.data_file,
         synpanel.files.pop_desc_file)
    kw = dict(chrom=22, start_bp=lo, end_bp=hi,
              pop_wgt=j_readers.pop_wgt_map_from_df(POP_WGT))
    return (j_pipeline.load_window(JFiles(*f), inp, **kw),
            t_pipeline.load_window(TFiles(*f), inp, **kw), lo, hi)


def test_pipeline_carried_over_identical(window):
    a, b, lo, hi = window
    pd.testing.assert_frame_equal(b.table, a.table)
    np.testing.assert_array_equal(b.G, a.G)
    np.testing.assert_array_equal(b.g_row, a.g_row)
    np.testing.assert_array_equal(b.pop_sizes, a.pop_sizes)
    np.testing.assert_array_equal(b.pop_wgts, a.pop_wgts)
    mid = (lo + hi) // 2
    for x, y in zip(t_pipeline.partition_window(b, lo, mid),
                    j_pipeline.partition_window(a, lo, mid)):
        np.testing.assert_array_equal(x, y)
    rows = np.flatnonzero(b.table["type"].to_numpy() == 1)
    np.testing.assert_array_equal(t_pipeline.genotypes_for(b, rows),
                                  j_pipeline.genotypes_for(a, rows))


def test_dosage_carried_over_identical():
    rng = np.random.default_rng(3)
    G = rng.integers(0, 3, size=(40, 50), dtype=np.int8)
    af = rng.uniform(0.0, 1.0, 40)
    z = rng.standard_normal(40)
    a1 = np.array(["A"] * 40, dtype=object)
    a2 = np.array(["C"] * 40, dtype=object)
    for fn in ("flip_dosage", "to_dominant", "to_recessive"):
        np.testing.assert_array_equal(getattr(t_dosage, fn)(G),
                                      getattr(j_dosage, fn)(G))
    for x, y in zip(t_dosage.minor_allele_update(G, af, z, a1, a2),
                    j_dosage.minor_allele_update(G, af, z, a1, a2)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fn", ["weighted_std", "weighted_corr",
                                "pooled_corr"])
def test_ldkernels_match_jax(window, fn):
    a, _, _, _ = window
    G = a.G[:60]
    sizes, wgts = a.pop_sizes, a.pop_wgts
    call = {"weighted_std": lambda m: m.weighted_std(G, sizes, wgts),
            "weighted_corr": lambda m: m.weighted_corr(G[:40], G[20:],
                                                       sizes, wgts),
            "pooled_corr": lambda m: m.pooled_corr(G[:40], G[20:])}[fn]
    got, ref = call(t_ld), call(j_ld)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    if got.ndim == 2:
        np.testing.assert_array_equal(t_ld.set_diag(got, 1.0),
                                      j_ld.set_diag(got, 1.0))


def test_zero_variance_nan_propagation_matches_jax(window):
    """A constant-heterozygous SNP has zero variance: its correlation row
    and column are not finite on both sides (the reference divides by a
    zero std: 0/0 or a rounding-sized covariance over 0), the rest stays
    finite and equal, and no warning escapes."""
    a, _, _, _ = window
    G = a.G[:12].copy()
    G[5, :] = 1
    sizes, wgts = a.pop_sizes, a.pop_wgts
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = t_ld.weighted_corr(G, G, sizes, wgts)
        pc = t_ld.pooled_corr(G, G)
    ref = j_ld.weighted_corr(G, G, sizes, wgts)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    assert not np.isfinite(got[5]).any()
    assert not np.isfinite(got[:, 5]).any()
    keep = np.arange(12) != 5
    np.testing.assert_allclose(got[np.ix_(keep, keep)],
                               ref[np.ix_(keep, keep)], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(np.isfinite(pc),
                                  np.isfinite(j_ld.pooled_corr(G, G)))
    assert np.isfinite(pc[np.ix_(keep, keep)]).all()


def test_linalg_matches_jax():
    rng = np.random.default_rng(11)
    V = np.linalg.qr(rng.standard_normal((30, 30)))[0]
    w = np.concatenate([np.full(4, 1e-3), rng.uniform(0.5, 3.0, 26)])
    A = (V * w) @ V.T
    At = torch.from_numpy(A)
    np.testing.assert_allclose(t_linalg.cholesky_lower(At).numpy(),
                               j_linalg.cholesky_lower(A),
                               rtol=RTOL, atol=ATOL)
    for cutoff in (1e-2, 1e-4):
        assert t_linalg.count_pc(At, cutoff) == j_linalg.count_pc(A, cutoff)
        got, n_got = t_linalg.rmv_pc(At, cutoff)
        ref, n_ref = j_linalg.rmv_pc(A, cutoff)
        assert n_got == n_ref
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)

"""qcat on gauss_tpu_torch's genome engine (PreparedRun.qcat_region, the
resident qcat kernel) against gauss_tpu on the same panel and input.

Tolerances (the JAX suite's own, tests/test_genome.py:120-152):
qcat_m equal; qcat_t rtol = atol = 2e-4 and qcat_chisq 5e-4 for f32
device tests against gauss_tpu's resident qcat_region and against the
float64 per-call qcatmix / qcat.  The device sides differ in their solve
algorithm (gauss_tpu: L^-1 B11 by a blocked solve; here L^T, the same
matrix in exact arithmetic).  A CUDA card against the CPU's plain
versions: the same bounds."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import gauss_tpu_torch
from gauss_tpu.io import readers as j_readers
from gauss_tpu.models.genome import GenomeEngine as JEngine
from gauss_tpu.models.genome import PanelStore as JStore
from gauss_tpu.ops import window_kernel as jwk
from gauss_tpu_torch.config import PanelFiles, Settings
from gauss_tpu_torch.models.genome import GenomeEngine, PanelStore
from gauss_tpu_torch.ops import gather, gram
from gauss_tpu_torch.ops import window_kernel as twk

POP_WGT = pd.DataFrame({"pop": ["AAA", "CCC", "EEE"],
                        "wgt": [0.5, 0.3, 0.2]})
STUDY_POP = "EUR"
AF1 = 0.05


@pytest.fixture(scope="module")
def setup(synpanel, gwas_input):
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    wing = (hi - lo) // 3
    inp = j_readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                                 wing_size=wing)
    jstore = JStore.from_bgzf(synpanel.files)
    tstore = PanelStore.from_bgzf(PanelFiles(
        synpanel.files.index_file, synpanel.files.data_file,
        synpanel.files.pop_desc_file))
    return dict(inp=inp, lo=lo, hi=hi, jstore=jstore, tstore=tstore,
                kw=dict(window_bp=(hi - lo) // 3 + 1, wing_size=wing),
                path=path, files=synpanel.files)


def _prepare(engine, kind, inp):
    if kind == "mix":
        return engine.prepare_mix(
            inp, dict(zip(POP_WGT["pop"], POP_WGT["wgt"])), af1_cutoff=AF1)
    return engine.prepare_homog(inp, STUDY_POP, af1_cutoff=AF1)


def _torch_run(setup, kind, device="cpu", settings=None):
    kw = {} if settings is None else dict(settings=settings)
    return _prepare(GenomeEngine(setup["tstore"], device,
                                 device_linalg=True, **kw),
                    kind, setup["inp"])


def _assert_qcat_close(got, ref, on=None):
    if on is None:
        assert list(got.columns) == list(ref.columns)
        assert len(got) == len(ref) > 0
        np.testing.assert_array_equal(got["rsid"].to_numpy(),
                                      ref["rsid"].to_numpy())
        g, r = got, ref
    else:
        m = got.merge(ref, on=on, suffixes=("_d", "_h"))
        assert len(m) == len(ref) > 0
        g = m[[c for c in m.columns if c.endswith("_d")]].rename(
            columns=lambda c: c[:-2])
        r = m[[c for c in m.columns if c.endswith("_h")]].rename(
            columns=lambda c: c[:-2])
    assert g["qcat_m"].dtype == np.int64
    np.testing.assert_array_equal(g["qcat_m"].to_numpy(),
                                  r["qcat_m"].to_numpy())
    np.testing.assert_allclose(g["qcat_t"], r["qcat_t"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(g["qcat_chisq"], r["qcat_chisq"], rtol=5e-4,
                               atol=5e-4)


@pytest.mark.parametrize("kind", ["mix", "homog"])
def test_qcat_region_matches_jax_resident(setup, kind):
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    got = _torch_run(setup, kind).qcat_region(lo, hi, **kw)
    ref = _prepare(JEngine(setup["jstore"], snp_bucket=64,
                           device_linalg=True, region_mode="resident"),
                   kind, setup["inp"]).qcat_region(lo, hi, **kw)
    _assert_qcat_close(got, ref)
    for col in ref.columns:
        if col not in ("qcat_t", "qcat_chisq", "qcat_pval"):
            assert got[col].dtype == ref[col].dtype, col
            np.testing.assert_array_equal(got[col].to_numpy(),
                                          ref[col].to_numpy())


@pytest.mark.parametrize("kind", ["mix", "homog"])
def test_qcat_region_matches_per_call(setup, kind):
    """One window against the per-call float64 API: qcatmix on a
    weighted run, qcat on a pooled one."""
    lo, hi = setup["lo"], setup["hi"]
    p_lo, p_hi = lo + (hi - lo) // 3, lo + 2 * (hi - lo) // 3
    wing = (hi - lo) // 3
    f = setup["files"]
    files = (setup["path"], f.index_file, f.data_file, f.pop_desc_file)
    if kind == "mix":
        host = gauss_tpu_torch.qcatmix(22, p_lo, p_hi, wing, POP_WGT,
                                       *files, af1_cutoff=AF1, device="cpu")
    else:
        host = gauss_tpu_torch.qcat(22, p_lo, p_hi, wing, STUDY_POP, *files,
                                    device="cpu")
    inp = j_readers.read_input_z(setup["path"], chrom=22, start_bp=p_lo,
                                 end_bp=p_hi, wing_size=wing)
    run = _prepare(GenomeEngine(setup["tstore"], "cpu"), kind, inp)
    dev = run.qcat_region(p_lo, p_hi, window_bp=p_hi - p_lo + 1,
                          wing_size=wing)
    _assert_qcat_close(dev, host, on=["rsid", "chr", "bp", "a1", "a2"])


def test_eig_cutoff_guard_and_spec_settings(setup):
    """The engine's kernel spec carries the run's min_abs_eig and
    eig_cutoff, and qcat_region refuses lambda <= eig_cutoff (its
    num_eig = M shortcut needs every eigenvalue above the cutoff)."""
    st = Settings(lambda_=0.05, min_abs_eig=2e-5, eig_cutoff=0.05)
    run = _torch_run(setup, "mix", settings=st)
    spec = run.engine._spec(run.pop_sizes, run.wgts)
    assert (spec.lam, spec.min_abs_eig, spec.eig_cutoff) == (0.05, 2e-5,
                                                              0.05)
    with pytest.raises(ValueError, match="eig_cutoff"):
        run.qcat_region(setup["lo"], setup["hi"], **setup["kw"])
    # the impute path has no such limit
    assert len(run.impute_region(setup["lo"], setup["hi"], **setup["kw"]))


def test_qcat_region_reuses_the_impute_batch(setup):
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    run = _torch_run(setup, "mix")
    assert run.qcat_region(1, 10, **kw).empty
    run.impute_region(lo, hi, **kw)
    batch = run._region_batch(lo, hi, kw["window_bp"], kw["wing_size"])
    q = run.qcat_region(lo, hi, **kw)
    assert run._region_batch(lo, hi, kw["window_bp"],
                             kw["wing_size"]) is batch
    # every emitted row of a tested window carries its window's M
    assert (q["qcat_m"] > 3).all()
    assert np.isfinite(q["qcat_t"]).all()


def test_masked_column_corr_matches_jax():
    rng = np.random.default_rng(21)
    W, Mp, C = 3, 64, 40
    Zt = rng.standard_normal((W, Mp)).astype(np.float32)
    X = rng.standard_normal((W, Mp, C)).astype(np.float32)
    mask = np.zeros((W, Mp), np.float32)
    for w, m in enumerate((64, 50, 9)):
        mask[w, :m] = 1.0
    X[2, :, 5] = 0.0                     # a constant column: the 1e-30 floor
    n = mask.sum(axis=1)
    ref = np.asarray(jwk._masked_column_corr(*(jnp.asarray(a) for a in
                                               (Zt, X, mask, n))))
    got = twk._masked_column_corr(*(torch.from_numpy(a) for a in
                                    (Zt, X, mask, n))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert got[2, 5] == 0.0


def test_qcat_tail_failed_window_gives_nan():
    rng = np.random.default_rng(22)
    B11 = torch.eye(8).repeat(2, 1, 1) * 1.1
    B11[1, 3, 3] = -1.0                  # window 1 is not positive definite
    B21 = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(
        np.float32)) * 0.1
    z1 = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    rhs = torch.cat([B21.transpose(1, 2), z1[:, :, None]], dim=2)
    out = twk._qcat_tail(B11, rhs, torch.ones(2, 8))
    assert out.shape == (2, 2 * 8 + 2 * 4 + 1)
    assert torch.isfinite(out[0]).all()
    assert torch.isnan(out[1, :-1]).all() and out[1, -1] == 8


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["mix", "homog"])
def test_qcat_region_on_gpu_matches_cpu(setup, kind):
    """The card path (K2 gathers, two K1 launches per slab) against the
    CPU's plain versions at the conftest size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    ref = _torch_run(setup, kind).qcat_region(lo, hi, **kw)
    gram.launches = gather.launches = 0
    got = _torch_run(setup, kind, "cuda:0").qcat_region(lo, hi, **kw)
    assert gram.launches >= 2 and gather.launches >= 1
    _assert_qcat_close(got, ref)

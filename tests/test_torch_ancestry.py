"""Ancestry in gauss_tpu_torch (afmix, cpw2, the prep_zmix family, zmix,
their PanelStore variants and the engine's wrappers), the carried-over
fiqt / qp / data modules and the float64 linalg helpers, against
gauss_tpu's on the conftest panel.

Tolerance: rtol 1e-10 (atol 1e-12).  Both sides take exact integer
statistics and float64 combines in the same order; the remaining
difference is LAPACK rounding of float64 eigen/inverse routines (numpy
on one side, torch on the other).  The port's store and per-call
variants run the same code on the same numbers: exactly equal."""

import numpy as np
import pandas as pd
import pytest
import torch

import gauss_tpu
import gauss_tpu_torch
from gauss_tpu.core import ldkernels as j_ld
from gauss_tpu.core import linalg as j_linalg
from gauss_tpu.io import readers as j_readers
from gauss_tpu.models import ancestry as j_anc
from gauss_tpu.models.genome import PanelStore as JStore
from gauss_tpu.utils.qp import solve_simplex_qp as j_qp
from gauss_tpu_torch.config import PanelFiles
from gauss_tpu_torch.core import ldkernels as t_ld
from gauss_tpu_torch.core import linalg as t_linalg
from gauss_tpu_torch.io import readers as t_readers
from gauss_tpu_torch.models import ancestry as t_anc
from gauss_tpu_torch.models.genome import GenomeEngine as TEngine
from gauss_tpu_torch.models.genome import PanelStore as TStore
from gauss_tpu_torch.utils import testing as t_testing
from gauss_tpu_torch.utils.qp import solve_simplex_qp as t_qp

RTOL, ATOL = 1e-10, 1e-12
TRUE_MIX = {"AAA": 0.35, "BBB": 0.25, "CCC": 0.0, "DDD": 0.15, "EEE": 0.25}


@pytest.fixture(scope="module")
def af_input(synpanel, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("af_t") / "afinput.txt")
    t_testing.make_af_input(synpanel, path, pop_mix=TRUE_MIX)
    return path


@pytest.fixture(scope="module")
def files(synpanel):
    return (synpanel.files.index_file, synpanel.files.data_file,
            synpanel.files.pop_desc_file)


@pytest.fixture(scope="module")
def stores(synpanel, files):
    return JStore.from_bgzf(synpanel.files), TStore.from_bgzf(
        PanelFiles(*files))


def _same(got, ref, rtol=RTOL, atol=ATOL):
    if isinstance(ref, pd.DataFrame):
        assert list(got.columns) == list(ref.columns) and len(ref) > 0
        for col in ref.columns:
            a, b = got[col].to_numpy(), ref[col].to_numpy()
            if b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                           err_msg=col)
            else:
                assert list(a) == list(b), col
    else:
        assert np.asarray(got).shape == np.asarray(ref).shape
        assert np.asarray(ref).size > 0
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", ["afmix", "cpw2"])
@pytest.mark.parametrize("interval", [8, 25])
def test_af_methods_match_gauss_tpu(name, interval, af_input, files):
    _same(getattr(gauss_tpu_torch, name)(af_input, *files,
                                         interval=interval),
          getattr(gauss_tpu, name)(af_input, *files, interval=interval))


ZMIX_CALLS = [
    ("prep_zmix", dict(interval=7)),
    ("prep_zmix2", dict(interval=13, offset=3)),
    ("prep_zmix3", dict(interval=11, steps=4)),
    ("prep_zmix4", dict(interval=13, offset=3)),
    ("prep_zmix5", dict(percentile=0.8, interval=2)),
    ("prep_zmix5_sup", dict(percentile=0.8, interval=2)),
    ("zmix", dict(percentile=0.5, interval=2)),
    ("zmix", dict(percentile=0.5, interval=2, level="superpopulation")),
]


@pytest.mark.parametrize("name, kw", ZMIX_CALLS,
                         ids=[f"{n}-{i}" for i, (n, _) in
                              enumerate(ZMIX_CALLS)])
def test_zmix_family_matches_gauss_tpu(name, kw, gwas_input, files):
    path, _ = gwas_input
    _same(getattr(gauss_tpu_torch, name)(path, *files, **kw),
          getattr(gauss_tpu, name)(path, *files, **kw))


def _store_calls(path, af_input):
    z_j = j_readers.read_input_z(path, all_snps=True)
    z_t = t_readers.read_input_z(path, all_snps=True)
    af_j, af_t = j_readers.read_input_af(af_input), \
        t_readers.read_input_af(af_input)
    zkw = dict(percentile=0.5, interval=2)
    return [
        # (store function, input for gauss_tpu, for the port, kwargs,
        #  the port's per-call twin)
        ("afmix_store", af_j, af_t, dict(interval=25),
         lambda f: gauss_tpu_torch.afmix(af_input, *f, interval=25)),
        ("cpw2_store", af_j, af_t, dict(interval=25),
         lambda f: gauss_tpu_torch.cpw2(af_input, *f, interval=25)),
        ("prep_zmix5_store", z_j, z_t, zkw,
         lambda f: gauss_tpu_torch.prep_zmix5(path, *f, **zkw)),
        ("prep_zmix5_store", z_j, z_t, dict(zkw, sup_level=True),
         lambda f: gauss_tpu_torch.prep_zmix5_sup(path, *f, **zkw)),
        ("zmix_store", z_j, z_t, zkw,
         lambda f: gauss_tpu_torch.zmix(path, *f, **zkw)),
        ("zmix_store", z_j, z_t, dict(zkw, level="superpopulation"),
         lambda f: gauss_tpu_torch.zmix(path, *f, **zkw,
                                        level="superpopulation")),
    ]


@pytest.mark.parametrize("case", range(6))
def test_store_variants_match_gauss_tpu_and_percall(case, gwas_input,
                                                    af_input, files,
                                                    stores):
    name, inp_j, inp_t, kw, percall = _store_calls(gwas_input[0],
                                                   af_input)[case]
    got = getattr(t_anc, name)(stores[1], inp_t, **kw)
    _same(got, getattr(j_anc, name)(stores[0], inp_j, **kw))
    _same(got, percall(files), rtol=0, atol=0)


def test_engine_wrappers_serve_the_store(stores, af_input, gwas_input):
    eng = TEngine(stores[1], device="cpu")
    af = t_readers.read_input_af(af_input)
    z = t_readers.read_input_z(gwas_input[0], all_snps=True)
    _same(eng.afmix(af, interval=25),
          t_anc.afmix_store(stores[1], af, interval=25), rtol=0, atol=0)
    _same(eng.cpw2(af, interval=25),
          t_anc.cpw2_store(stores[1], af, interval=25), rtol=0, atol=0)
    _same(eng.prep_zmix5(z, percentile=0.5, interval=2, sup_level=True),
          t_anc.prep_zmix5_store(stores[1], z, 0.5, 2, True), rtol=0,
          atol=0)
    _same(eng.zmix(z, percentile=0.5, interval=2),
          t_anc.zmix_store(stores[1], z, 0.5, 2), rtol=0, atol=0)


def test_afmix_recovers_the_mixture(af_input, files):
    res = gauss_tpu_torch.afmix(af_input, *files, interval=8)
    w = dict(zip(res["pop"], res["wgt"]))
    for p, true_w in TRUE_MIX.items():
        assert abs(w.get(p, 0.0) - true_w) < 0.12, (p, w)


def test_qp_copy_identical():
    rng = np.random.default_rng(5)
    for _ in range(10):
        n = int(rng.integers(3, 12))
        A = rng.standard_normal((30, n))
        D = A.T @ A + 0.05 * np.eye(n)
        d = rng.standard_normal(n)
        np.testing.assert_array_equal(t_qp(D, d), j_qp(D, d))


def test_fiqt_and_bundled_weights_identical():
    rng = np.random.default_rng(11)
    z = np.concatenate([rng.normal(size=500) * 3, [40.0, -45.0, 0.0]])
    np.testing.assert_array_equal(gauss_tpu_torch.fiqt(z),
                                  gauss_tpu.fiqt(z))
    np.testing.assert_array_equal(gauss_tpu_torch.fiqt(z, min_p=1e-10),
                                  gauss_tpu.fiqt(z, min_p=1e-10))
    pd.testing.assert_frame_equal(gauss_tpu_torch.pgc2_scz_anc_prop(),
                                  gauss_tpu.pgc2_scz_anc_prop())
    pd.testing.assert_frame_equal(gauss_tpu_torch.PGC2_SCZ_ANC_Prop,
                                  gauss_tpu.PGC2_SCZ_ANC_Prop)


def test_per_pop_corr_and_linalg_helpers_match(synpanel):
    G = synpanel.genotypes[:40]
    sizes = tuple(int(x) for x in synpanel.desc.sizes)
    _same(t_ld.per_pop_corr(G, sizes), j_ld.per_pop_corr(G, sizes))
    rng = np.random.default_rng(4)
    m = rng.normal(size=(50, 6))
    t = torch.from_numpy(m)
    cov = j_linalg.cal_cov_mat(m)
    _same(t_linalg.cal_cov_mat(t).numpy(), cov)
    _same(t_linalg.cal_cor_mat(t).numpy(), j_linalg.cal_cor_mat(m))
    _same(t_linalg.cov_to_cor(torch.from_numpy(cov)).numpy(),
          j_linalg.cov_to_cor(cov))
    assert t_linalg.cal_cor_vec(t[:, 0], t[:, 1]) == pytest.approx(
        j_linalg.cal_cor_vec(m[:, 0], m[:, 1]), rel=RTOL)

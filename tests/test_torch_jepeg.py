"""jepeg / jepegmix of gauss_tpu_torch against gauss_tpu's: the per-call
functions, the engine's gene path (prepare_genes -> jepeg_region, gene
blocks gathered by K2) and the gene kernels under them, on the conftest
panel with make_annotation's genes.

Tolerance: rtol 1e-10 (atol 1e-12) on every float column; integer and
string columns equal.  Both sides take exact integer statistics in
float32 and combine them in float64 in the same population order; what
remains is LAPACK rounding of the k <= 6 eigen/inverse steps (numpy on
one side, torch on the other).  The card against the CPU: rtol 1e-9 (the
float64 contractions run in another order on the card)."""

import numpy as np
import pandas as pd
import pytest
import torch

import gauss_tpu
import gauss_tpu_torch
from gauss_tpu.core import genekernels as j_gk
from gauss_tpu.io import readers as j_readers
from gauss_tpu.models.genome import GenomeEngine as JEngine
from gauss_tpu.models.genome import PanelStore as JStore
from gauss_tpu_torch.config import PanelFiles
from gauss_tpu_torch.core import genekernels as t_gk
from gauss_tpu_torch.io import readers as t_readers
from gauss_tpu_torch.models.genome import GenomeEngine as TEngine
from gauss_tpu_torch.models.genome import PanelStore as TStore
from gauss_tpu_torch.ops import gather
from gauss_tpu_torch.utils import testing as t_testing

RTOL, ATOL = 1e-10, 1e-12
POP_WGT = {"AAA": 0.4, "BBB": 0.35, "EEE": 0.25}
STUDY_POP = "EUR"            # a super-population over two panel segments
MODES = [dict(study_pop=STUDY_POP), dict(pop_wgt=POP_WGT)]
MODE_IDS = ["jepeg", "jepegmix"]


@pytest.fixture(scope="module")
def annot_file(synpanel, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("annot_t") / "annot.txt")
    t_testing.make_annotation(synpanel, path)
    return path


@pytest.fixture(scope="module")
def panels(synpanel):
    files = (synpanel.files.index_file, synpanel.files.data_file,
             synpanel.files.pop_desc_file)
    return files, JStore.from_bgzf(synpanel.files), \
        TStore.from_bgzf(PanelFiles(*files))


@pytest.fixture(scope="module")
def inputs(gwas_input, annot_file):
    path, _ = gwas_input
    return (t_readers.read_input_z(path, all_snps=True),
            t_readers.read_annotation(annot_file))


def _sorted(df):
    return df.sort_values("geneid", kind="stable").reset_index(drop=True)


def _assert_frames(got, ref, rtol=RTOL, atol=ATOL):
    got, ref = _sorted(got), _sorted(ref)
    assert list(got.columns) == list(ref.columns)
    assert len(ref) > 0 and (ref["df"] > 0).sum() >= 3
    for col in ref.columns:
        a, b = got[col].to_numpy(), ref[col].to_numpy()
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=col)
        else:
            assert list(a) == list(b), col


def _percall(pkg, mode, path, annot_file, files):
    if "study_pop" in mode:
        return pkg.jepeg(mode["study_pop"], path, annot_file, *files)
    wgt = pd.DataFrame({"pop": list(POP_WGT), "wgt": list(POP_WGT.values())})
    return pkg.jepegmix(wgt, path, annot_file, *files)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_percall_matches_gauss_tpu(mode, panels, gwas_input, annot_file):
    files = panels[0]
    path, _ = gwas_input
    _assert_frames(_percall(gauss_tpu_torch, mode, path, annot_file, files),
                   _percall(gauss_tpu, mode, path, annot_file, files))


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_engine_jepeg_region_matches_gauss_tpu_and_percall(
        mode, panels, inputs, gwas_input, annot_file):
    files, jstore, tstore = panels
    inp, annot = inputs
    got = TEngine(tstore, device="cpu").prepare_genes(
        inp, annot, **mode).jepeg_region()
    ref = JEngine(jstore).prepare_genes(
        j_readers.read_input_z(gwas_input[0], all_snps=True),
        j_readers.read_annotation(annot_file), **mode).jepeg_region()
    _assert_frames(got, ref)
    _assert_frames(got, _percall(gauss_tpu_torch, mode, gwas_input[0],
                                 annot_file, files))


def test_engine_gene_chunks_partition_the_genes(panels, inputs, synpanel):
    """Genes go to the chunk of their first SNP: two halves of the span
    give the whole run's rows, equal."""
    inp, annot = inputs
    pg = TEngine(panels[2], device="cpu").prepare_genes(inp, annot,
                                                        pop_wgt=POP_WGT)
    whole = pg.jepeg_region()
    bps = synpanel.index_df["bp"]
    mid = int((bps.min() + bps.max()) // 2)
    both = pd.concat([pg.jepeg_region(int(bps.min()), mid),
                      pg.jepeg_region(mid + 1, int(bps.max()))],
                     ignore_index=True)
    _assert_frames(both, whole, rtol=0, atol=0)
    assert len(pg.jepeg_region(0, int(bps.min()) - 1)) == 0


def test_engine_gene_path_gathers_with_k2(panels, inputs, monkeypatch):
    """The engine's gene path gathers each bucket's rows through K2's
    wrapper, -1 sentinels padding the bucket."""
    calls = []
    real = gather.gather_rows

    def spy(G, idx):
        calls.append(idx.clone())
        return real(G, idx)

    monkeypatch.setattr(t_gk, "gather_rows", spy)
    inp, annot = inputs
    pg = TEngine(panels[2], device="cpu").prepare_genes(inp, annot,
                                                        study_pop=STUDY_POP)
    pg.jepeg_region()
    sizes = {t_gk._bucket(e - s) for s, e in pg.spans}
    assert len(calls) >= len(sizes) >= 1
    assert any(bool((c < 0).any()) for c in calls)
    assert pg._device_panel().shape[1] % 16 == 0


def test_gene_stats_resident_pad_row_nan_safe():
    """A monomorphic panel row (NaN correlations) must not reach CovU
    through the pad rows of a bucket, as in gauss_tpu; the statistics
    match gauss_tpu's and the dense host contraction."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    pop_sizes = (24, 16)
    G = rng.integers(0, 3, size=(10, 40)).astype(np.int8)
    G[0] = 1
    Gt = torch.from_numpy(np.pad(G, ((0, 0), (0, 8))))   # S padded to 48
    gene_idx = [np.array([2, 5, 7], dtype=np.int32),
                np.array([0, 3], dtype=np.int32)]        # a NaN real row
    Ws = [rng.normal(size=(6, len(g))) for g in gene_idx]
    zs = [rng.normal(size=len(g)) for g in gene_idx]
    for wgts in (None, (0.6, 0.4)):
        got = t_gk.gene_stats_resident(Gt, gene_idx, Ws, zs, pop_sizes,
                                       wgts, lam=0.1)
        ref = j_gk.gene_stats_resident(jnp.asarray(G), gene_idx, Ws, zs,
                                       pop_sizes, wgts, lam=0.1)
        for g, r in zip(got, ref):
            for a, b in zip(g, r):
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        CovU, WWt, U = got[0]
        assert np.isfinite(CovU).all() and np.isfinite(U).all()
        assert not np.isfinite(got[1][0]).all()      # real NaN propagates
        corr = t_gk.gene_corr_matrices([G[gene_idx[0]]], pop_sizes,
                                       wgts)[0].copy()
        np.fill_diagonal(corr, 1.1)
        np.testing.assert_allclose(CovU, Ws[0] @ corr @ Ws[0].T,
                                   atol=1e-10)
        np.testing.assert_allclose(U, Ws[0] @ zs[0], atol=1e-12)


@pytest.mark.parametrize("wgts", [None, (0.5, 0.3, 0.2)],
                         ids=["pooled", "weighted"])
def test_gene_corr_resident_matches_gene_corr_matrices(wgts):
    """Including a gene whose bucket exceeds max_batch_elems (admitted
    alone) and several bucket sizes; both against gauss_tpu's host
    gene_corr_matrices."""
    rng = np.random.default_rng(3)
    pop_sizes = (40, 24, 32)
    G = rng.integers(0, 3, size=(60, 96)).astype(np.int8)
    gene_idx = [np.arange(12, dtype=np.int32),
                np.array([1, 2, 3], dtype=np.int32),
                rng.choice(60, 30, replace=False).astype(np.int32),
                np.array([59], dtype=np.int32)]
    blocks = [G[g] for g in gene_idx]
    ref = j_gk.gene_corr_matrices(blocks, pop_sizes, wgts,
                                  max_batch_elems=512)
    host = t_gk.gene_corr_matrices(blocks, pop_sizes, wgts,
                                   max_batch_elems=512)
    dev = t_gk.gene_corr_resident(torch.from_numpy(G), gene_idx, pop_sizes,
                                  wgts, max_batch_elems=512)
    for a, b, c in zip(host, dev, ref):
        assert a.shape == c.shape
        np.testing.assert_allclose(a, c, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(b, a)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_engine_jepeg_region_on_gpu_matches_cpu(mode, panels, inputs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    inp, annot = inputs
    ref = TEngine(panels[2], device="cpu").prepare_genes(
        inp, annot, **mode).jepeg_region()
    before = gather.launches
    got = TEngine(panels[2], device="cuda").prepare_genes(
        inp, annot, **mode).jepeg_region()
    assert gather.launches > before
    _assert_frames(got, ref, rtol=1e-9, atol=1e-12)

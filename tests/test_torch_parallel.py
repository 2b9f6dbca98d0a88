"""gauss_tpu_torch's device mesh (parallel/mesh.py) against the port on
one device and against gauss_tpu's mesh, on the CPU.

The meshes repeat the ``cpu`` device: a (W x S) mesh then runs W window
groups of S subject shards through the same code a grid of cards runs
(the kernels' plain versions on the CPU).  gauss_tpu's side runs on the
conftest's 8 virtual CPU devices.

Bars: a 1x1 mesh is bit-equal to the engine on one device (one shard, the
same batch, the same T1).  Other shapes add the shards' f32 partials of
T1 in another order than one fold: z and info rtol 1e-5 / atol 5e-6,
qcat_m equal, qcat_t rtol 1e-4 / atol 1e-5, LD cormat atol 4e-5 (both
sides quantized), as tests/test_parallel.py holds gauss_tpu's mesh to its
own single device, on its region and windows.  Against gauss_tpu's 2x4
mesh, the port's f32 region bar (tests/test_torch_genome.py: z rtol 2e-4
/ atol 1e-4, info rtol 2e-4 / atol 2e-5).  Gene partials and zmix's pair
statistics are exact integers: jepeg genes rtol 1e-12, zmix atol 0.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from gauss_tpu.io import readers as j_readers
from gauss_tpu.models import ancestry as j_anc
from gauss_tpu.models.genome import GenomeEngine as JEngine
from gauss_tpu.models.genome import PanelStore as JStore
from gauss_tpu.ops.window_kernel import WindowKernelSpec as JSpec
from gauss_tpu.parallel import mesh as j_mesh
from gauss_tpu_torch import entry
from gauss_tpu_torch.config import PanelFiles
from gauss_tpu_torch.io import readers as t_readers
from gauss_tpu_torch.models import ancestry as t_anc
from gauss_tpu_torch.models.genome import GenomeEngine, PanelStore
from gauss_tpu_torch.ops import window_kernel as twk
from gauss_tpu_torch.ops.gram import K_CHUNK
from gauss_tpu_torch.parallel import mesh as t_mesh
from gauss_tpu_torch.utils import testing as t_testing

POP_WGT = {"AAA": 0.5, "CCC": 0.3, "EEE": 0.2}
STUDY_POP = "BBB"
SHAPES = [(1, 1), (1, 2), (2, 2), (2, 4)]
SHAPE_IDS = [f"{w}x{s}" for w, s in SHAPES]
Z_BAR = dict(rtol=1e-5, atol=5e-6)
QT_BAR = dict(rtol=1e-4, atol=1e-5)
LD_ATOL = 4e-5


def cpu_mesh(n_window, n_subject):
    return t_mesh.make_mesh(n_window, n_subject,
                            devices=["cpu"] * (n_window * n_subject))


@pytest.fixture(scope="module")
def setup(synpanel, gwas_input):
    """tests/test_parallel.py's region: the conftest panel's 300 SNPs in
    75 kb windows with 40 kb wings."""
    path, _ = gwas_input
    lo, hi = 1_000_000, 1_299_000
    inp = j_readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                                 wing_size=0)
    kw = dict(window_bp=75_000, wing_size=40_000)
    files = (synpanel.files.index_file, synpanel.files.data_file,
             synpanel.files.pop_desc_file)
    return dict(inp=inp, lo=lo, hi=hi, kw=kw, path=path,
                jstore=JStore.from_bgzf(synpanel.files),
                tstore=PanelStore.from_bgzf(PanelFiles(*files)))


def _prepare(engine, kind, inp, cutoff=0.01):
    if kind == "mix":
        return engine.prepare_mix(inp, POP_WGT, af1_cutoff=cutoff)
    return engine.prepare_homog(inp, STUDY_POP, af1_cutoff=cutoff)


def _pair(setup, shape, kind="mix", cutoff=0.01):
    """(one-device run, mesh run) of the port on the same input."""
    one = GenomeEngine(setup["tstore"], "cpu", device_linalg=True)
    mesh = GenomeEngine(setup["tstore"], mesh=cpu_mesh(*shape))
    return (_prepare(one, kind, setup["inp"], cutoff),
            _prepare(mesh, kind, setup["inp"], cutoff))


def _same_rows(got, ref, cols=("rsid", "bp", "type")):
    assert len(got) == len(ref) > 0
    for c in cols:
        np.testing.assert_array_equal(got[c].to_numpy(), ref[c].to_numpy())


def _close(got, ref, col, exact, **bar):
    if exact:
        np.testing.assert_array_equal(got[col].to_numpy(), ref[col].to_numpy())
    else:
        np.testing.assert_allclose(got[col].to_numpy(), ref[col].to_numpy(),
                                   **bar)


# -- layouts ----------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_layouts_match_gauss_tpu(n_shards):
    rng = np.random.default_rng(n_shards)
    for sizes in [(13, 21, 9), (1, 2, 3), (40, 55, 35, 50, 45), (7,)]:
        G = rng.integers(0, 3, size=(5, sum(sizes)), dtype=np.int8)
        a = t_mesh.subject_shard_layout(G, sizes, n_shards)
        b = j_mesh.subject_shard_layout(G, sizes, n_shards)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
        v = t_mesh.subject_valid_layout(sizes, n_shards)
        np.testing.assert_array_equal(v, j_mesh.subject_valid_layout(
            sizes, n_shards))
        # the per-shard valid counts are the mask's ones, shard by shard
        counts = t_mesh.subject_valid_counts(sizes, n_shards)
        locs = a[2]
        for j, row in enumerate(counts):
            blk = v[j * sum(locs):(j + 1) * sum(locs)]
            o = 0
            for k, loc in enumerate(locs):
                seg = blk[o:o + loc]
                assert seg.sum() == row[k] and (seg[:row[k]] == 1).all()
                o += loc


# -- the split preparation --------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("weighted", [True, False])
def test_split_preparation_matches_unsharded(n_shards, weighted):
    """prepare_sharded_panel over shard_columns' shards against
    prepare_resident_panel on the whole panel: Sp, Mu and V equal, every
    shard's valid columns the unsharded X's columns, padding zero."""
    rng = np.random.default_rng(7 + n_shards)
    sizes = (13, 70, 9)
    wgts = (0.5, 0.3, 0.2) if weighted else None
    G = rng.integers(0, 3, size=(50, sum(sizes)), dtype=np.int8)
    rows = rng.integers(0, 50, size=40).astype(np.int32)
    rows[[3, 17, 39]] = -1
    Gp, padded = twk.pad_pop_segments(G, sizes, multiple=K_CHUNK)
    spec = twk.WindowKernelSpec(pop_sizes=sizes, pop_sizes_padded=padded,
                                wgts=wgts)
    X, Sp, Mu, V = twk.prepare_resident_panel(
        torch.from_numpy(np.ascontiguousarray(Gp)), torch.from_numpy(rows),
        None, spec)
    blocks, locs, widths = t_mesh.shard_columns(G, sizes, n_shards)
    sspec = t_mesh.sharded_spec(sizes, wgts, n_shards)
    assert sspec.pop_sizes_padded == widths
    Xs, Sp2, Mu2, V2 = twk.prepare_sharded_panel(
        [torch.from_numpy(b) for b in blocks],
        [torch.from_numpy(rows)] * n_shards, None, sspec)
    for a, b in ((Sp2, Sp), (Mu2, Mu), (V2, V)):
        assert torch.equal(a, b)
    bounds, lbounds = spec.bounds, sspec.bounds
    for k, m in enumerate(sizes):
        cols = torch.cat([Xs[j][:, int(lbounds[k]):int(lbounds[k])
                                + sspec.valid_counts[j][k]]
                          for j in range(n_shards)], dim=1)
        assert torch.equal(cols, X[:, int(bounds[k]):int(bounds[k]) + m])
    for j, Xj in enumerate(Xs):
        keep = torch.zeros(Xj.shape[1], dtype=torch.bool)
        for k in range(len(sizes)):
            lo = int(lbounds[k])
            keep[lo:lo + sspec.valid_counts[j][k]] = True
        assert not Xj[:, ~keep].any()


# -- the engine on a mesh against one device ----------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("kind", ["mix", "homog"])
def test_mesh_impute_region_matches_one_device(setup, shape, kind):
    one, mesh = _pair(setup, shape, kind)
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    ref = one.impute_region(lo, hi, **kw)
    got = mesh.impute_region(lo, hi, **kw)
    _same_rows(got, ref)
    exact = shape == (1, 1)
    for col in ("z", "info"):
        _close(got, ref, col, exact, **Z_BAR)
    b = mesh._region_batch(lo, hi, kw["window_bp"], kw["wing_size"])
    assert len(b.groups) == shape[0]
    Xm = b.groups[-1].arrays[0]
    assert (len(Xm) if isinstance(Xm, tuple) else 1) == shape[1]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mesh_qcat_region_matches_one_device(setup, shape):
    one, mesh = _pair(setup, shape, cutoff=0.05)
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    ref = one.qcat_region(lo, hi, **kw)
    got = mesh.qcat_region(lo, hi, **kw)
    _same_rows(got, ref, ("rsid", "bp", "type", "qcat_m"))
    _close(got, ref, "qcat_t", shape == (1, 1), **QT_BAR)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("fetch", ["i16tri", "f32"])
def test_mesh_ld_region_matches_one_device(setup, shape, fetch):
    one, mesh = _pair(setup, shape)
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    w = (hi - lo) // 4 + 1
    ref = one.ld_region(lo, hi, window_bp=w, fetch=fetch)
    got = mesh.ld_region(lo, hi, window_bp=w, fetch=fetch)
    assert len(got) == len(ref) == 4
    for a, b in zip(got, ref):
        pd.testing.assert_frame_equal(a["snplist"], b["snplist"])
        assert a["fetch"] == b["fetch"] == fetch
        if shape == (1, 1):
            np.testing.assert_array_equal(a["cormat"], b["cormat"])
        else:
            np.testing.assert_allclose(a["cormat"], b["cormat"], rtol=0,
                                       atol=LD_ATOL)
    a = mesh.ld_window(lo, lo + w - 1, fetch=fetch)
    np.testing.assert_allclose(a["cormat"], ref[0]["cormat"], rtol=0,
                               atol=LD_ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mesh_impute_window_matches_one_device(setup, shape):
    one, mesh = _pair(setup, shape)
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    a = lo
    while a <= hi:
        b = min(a + kw["window_bp"] - 1, hi)
        ref = one.impute_window(a, b, kw["wing_size"])
        got = mesh.impute_window(a, b, kw["wing_size"])
        assert (got.n_measured, got.n_unmeasured) == (ref.n_measured,
                                                      ref.n_unmeasured)
        _same_rows(got.table, ref.table)
        for col in ("z", "info"):
            _close(got.table, ref.table, col, shape == (1, 1), **Z_BAR)
        a = b + 1
    assert mesh.impute_window(1, 10, kw["wing_size"]) is None


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_mesh_shared_layout_fallback(setup, shape, monkeypatch):
    """Above the byte cap the mesh takes the shared layout: every window
    group holds both halves on its shards, and the output stays within
    the bar of the aligned one."""
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    ref = _pair(setup, shape)[1].impute_region(lo, hi, **kw)
    monkeypatch.setenv("GAUSS_ALIGNED_MAX_BYTES", "1")
    mesh = _pair(setup, shape)[1]
    got = mesh.impute_region(lo, hi, **kw)
    assert not mesh._region_batch(lo, hi, kw["window_bp"],
                                  kw["wing_size"]).aligned
    _same_rows(got, ref)
    for col in ("z", "info"):
        _close(got, ref, col, False, rtol=1e-6, atol=1e-6)


def test_byte_cap_counts_every_shard_on_a_device(setup, monkeypatch):
    """Two subject shards on one device hold twice the bands of one: a
    cap the one-device batch just meets sends a (1 x 2) mesh on that
    device to the shared layout."""
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    one, mesh = _pair(setup, (1, 2))
    b = one._region_batch(lo, hi, kw["window_bp"], kw["wing_size"])
    S = sum(one.engine._padded_sizes(one.pop_sizes))
    assert S == sum(mesh.engine._padded_sizes(mesh.pop_sizes))
    monkeypatch.setenv("GAUSS_ALIGNED_MAX_BYTES",
                       str(len(b.plans) * (b.Mp + b.Up) * S))
    one, mesh = _pair(setup, (1, 2))
    assert one._region_batch(lo, hi, kw["window_bp"],
                             kw["wing_size"]).aligned
    assert not mesh._region_batch(lo, hi, kw["window_bp"],
                                  kw["wing_size"]).aligned


def test_mesh_region_handles_and_pipelining(setup):
    """impute_regions on a 2x2 mesh: each handle waits on both window
    groups and the frames equal the blocking calls."""
    _, mesh = _pair(setup, (2, 2))
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    mid = (lo + hi) // 2
    spans = [(lo, mid), (mid + 1, hi), (lo, hi)]
    seq = [mesh.impute_region(a, b, **kw) for a, b in spans]
    for (_, _, df), ref in zip(mesh.impute_regions(spans, depth=2, **kw),
                               seq):
        pd.testing.assert_frame_equal(df, ref)


# -- against gauss_tpu's mesh -------------------------------------------------

def _assert_f32_region_bar(df_t, df_j):
    _same_rows(df_t, df_j)
    imp = df_j["type"].to_numpy() == 0
    for col in ("z", "info"):
        np.testing.assert_array_equal(df_t[col].to_numpy()[~imp],
                                      df_j[col].to_numpy()[~imp])
    np.testing.assert_allclose(df_t["z"].to_numpy()[imp],
                               df_j["z"].to_numpy()[imp], rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(df_t["info"].to_numpy()[imp],
                               df_j["info"].to_numpy()[imp], rtol=2e-4,
                               atol=2e-5)


@pytest.fixture(scope="module")
def jax_mesh_runs(setup):
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs gauss_tpu's 8 virtual devices")
    eng = JEngine(setup["jstore"], snp_bucket=64,
                  mesh=j_mesh.make_mesh(2, 4))
    return {c: _prepare(eng, "mix", setup["inp"], c) for c in (0.01, 0.05)}


def test_mesh_matches_gauss_tpu_mesh(setup, jax_mesh_runs):
    """impute_region, impute_window, qcat_region and ld_region on the
    port's 2x4 mesh against gauss_tpu's engine on its 2x4 mesh."""
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    t = GenomeEngine(setup["tstore"], mesh=cpu_mesh(2, 4))
    trun, tq = (_prepare(t, "mix", setup["inp"], c) for c in (0.01, 0.05))
    jrun, jq = jax_mesh_runs[0.01], jax_mesh_runs[0.05]
    _assert_f32_region_bar(trun.impute_region(lo, hi, **kw),
                           jrun.impute_region(lo, hi, **kw))
    span = (lo, lo + kw["window_bp"] - 1)
    _assert_f32_region_bar(trun.impute_window(*span, kw["wing_size"]).table,
                           jrun.impute_window(*span, kw["wing_size"]).table)
    a, b = tq.qcat_region(lo, hi, **kw), jq.qcat_region(lo, hi, **kw)
    _same_rows(a, b, ("rsid", "bp", "type", "qcat_m"))
    np.testing.assert_allclose(a["qcat_t"], b["qcat_t"], rtol=2e-4,
                               atol=2e-4)
    for fetch in ("i16tri", "f32"):
        la = trun.ld_region(lo, hi, window_bp=kw["window_bp"], fetch=fetch)
        lb = jrun.ld_region(lo, hi, window_bp=kw["window_bp"], fetch=fetch)
        assert len(la) == len(lb) > 0
        for x, y in zip(la, lb):
            assert list(x["snplist"]["rsid"]) == list(y["snplist"]["rsid"])
            np.testing.assert_allclose(x["cormat"], y["cormat"], rtol=0,
                                       atol=2e-4 + twk.LD_I16_MAX_ERR)


def _toy(n_windows=4, M=20, U=12, seed=11, sizes=(13, 21, 9)):
    rng = np.random.default_rng(seed)
    S = sum(sizes)
    Gm = rng.integers(0, 3, size=(n_windows, M, S), dtype=np.int8)
    Gu = rng.integers(0, 3, size=(n_windows, U, S), dtype=np.int8)
    Z1 = rng.standard_normal((n_windows, M))
    m_mask = np.ones((n_windows, M), dtype=np.float32)
    u_mask = np.ones((n_windows, U), dtype=np.float32)
    m_mask[:, -2:] = 0
    u_mask[:, -1:] = 0
    Gm[:, -2:] = 0
    Gu[:, -1:] = 0
    Z1[:, -2:] = 0
    return Gm, Gu, Z1, m_mask, u_mask


@pytest.mark.parametrize("wgts", [(0.4, 0.35, 0.25), None],
                         ids=["weighted", "pooled"])
def test_sharded_wrappers_match_gauss_tpu(wgts):
    """sharded_region_impute and sharded_window_impute on the same
    subject-shard layout as gauss_tpu's (its tests/test_parallel.py
    inputs), at the f32 region bar; build_sharded_qcat_region_kernel and
    build_sharded_ld_kernel beside them."""
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs gauss_tpu's 8 virtual devices")
    sizes = (13, 21, 9)
    Gm, Gu, Z1, m_mask, u_mask = _toy()
    Gm_l, _, locs = t_mesh.subject_shard_layout(Gm, sizes, 4)
    Gu_l, _, _ = t_mesh.subject_shard_layout(Gu, sizes, 4)
    kw = dict(true_pop_sizes=sizes, local_pop_sizes=locs, wgts=wgts)
    real = u_mask > 0
    tz, ti = t_mesh.sharded_window_impute(cpu_mesh(2, 4), Gm_l, Gu_l, Z1,
                                          m_mask, u_mask, **kw)
    jz, ji = j_mesh.sharded_window_impute(j_mesh.make_mesh(2, 4), Gm_l,
                                          Gu_l, Z1, m_mask, u_mask, **kw)
    np.testing.assert_allclose(tz[real], np.asarray(jz)[real], rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ti[real], np.asarray(ji)[real], rtol=2e-4,
                               atol=2e-5)

    rng = np.random.default_rng(21)
    R, Mp, Up, W = 300, 24, 16, 4
    G = rng.integers(0, 3, size=(R, sum(sizes)), dtype=np.int8)
    m_idx = rng.integers(0, R, size=(W, Mp)).astype(np.int32)
    u_idx = rng.integers(0, R, size=(W, Up)).astype(np.int32)
    Z1 = rng.standard_normal((W, Mp))
    m_mask = np.ones((W, Mp), np.float32)
    u_mask = np.ones((W, Up), np.float32)
    m_mask[:, -3:] = 0
    u_mask[:, -2:] = 0
    Z1[:, -3:] = 0
    G_l, _, locs = t_mesh.subject_shard_layout(G, sizes, 4)
    args = (G_l, m_idx, u_idx, Z1, m_mask, u_mask)
    kw["local_pop_sizes"] = locs
    tz, ti = t_mesh.sharded_region_impute(cpu_mesh(2, 4), *args, **kw)
    jz, ji = j_mesh.sharded_region_impute(j_mesh.make_mesh(2, 4), *args,
                                          **kw)
    real = u_mask > 0
    np.testing.assert_allclose(tz[real], np.asarray(jz)[real], rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ti[real], np.asarray(ji)[real], rtol=2e-4,
                               atol=2e-5)
    if wgts is None:
        return
    spec = JSpec(pop_sizes=sizes, pop_sizes_padded=locs, wgts=wgts)
    tq = t_mesh.build_sharded_qcat_region_kernel(spec, cpu_mesh(2, 4))(*args)
    jq = j_mesh.build_sharded_qcat_region_kernel(
        spec, j_mesh.make_mesh(2, 4))(*args)
    np.testing.assert_array_equal(tq[4], np.asarray(jq[4]))
    mm = m_mask > 0
    np.testing.assert_allclose(tq[0][mm], np.asarray(jq[0])[mm], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(tq[2][real], np.asarray(jq[2])[real],
                               rtol=2e-4, atol=2e-4)
    tl = t_mesh.build_sharded_ld_kernel(spec, cpu_mesh(2, 4))(
        G_l, m_idx, m_mask)
    jl = np.asarray(j_mesh.build_sharded_ld_kernel(
        spec, j_mesh.make_mesh(2, 4))(G_l, m_idx, m_mask))
    sel = mm[:, :, None] & mm[:, None, :]
    np.testing.assert_allclose(tl[sel], jl[sel], rtol=0, atol=2e-4)
    tt = t_mesh.build_sharded_ld_kernel(spec, cpu_mesh(2, 4),
                                        fetch="i16tri")(G_l, m_idx, m_mask)
    assert tt.shape == (W, Mp * (Mp + 1) // 2) and tt.dtype == np.int16


# -- gene tests and ancestry ------------------------------------------------

@pytest.fixture(scope="module")
def gene_inputs(synpanel, gwas_input, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("annot_mesh") / "annot.txt")
    t_testing.make_annotation(synpanel, path)
    return (t_readers.read_input_z(gwas_input[0], all_snps=True),
            t_readers.read_annotation(path))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("mode", [dict(study_pop="EUR"),
                                  dict(pop_wgt={"AAA": 0.4, "BBB": 0.35,
                                                "EEE": 0.25})],
                         ids=["jepeg", "jepegmix"])
def test_mesh_genes_match_one_device(setup, gene_inputs, shape, mode):
    """Gene buckets split over the window groups, exact partials summed
    over the shards: every gene as on one device (rtol 1e-12)."""
    inp, annot = gene_inputs
    ref = GenomeEngine(setup["tstore"], "cpu").prepare_genes(
        inp, annot, **mode).jepeg_region()
    got = GenomeEngine(setup["tstore"], mesh=cpu_mesh(*shape)).prepare_genes(
        inp, annot, **mode).jepeg_region()
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) > 0 and (ref["df"] > 0).sum() >= 3
    for col in ref.columns:
        a, b = got[col].to_numpy(), ref[col].to_numpy()
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300,
                                       equal_nan=True, err_msg=col)
        else:
            assert list(a) == list(b), col


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mesh_zmix_is_exact(setup, shape):
    """prep_zmix5_store and zmix_store with mesh=: bit-equal to the
    unsharded call; zmix's weights bit-equal to gauss_tpu's 2x4 mesh, its
    prep_zmix5 matrix within the last bit of it (torch's float64 sqrt and
    numpy's can round apart)."""
    import jax
    inp = t_readers.read_input_z(setup["path"], all_snps=True)
    jinp = j_readers.read_input_z(setup["path"], all_snps=True)
    m = cpu_mesh(*shape)
    jm = j_mesh.make_mesh(2, 4) if len(jax.devices()) >= 8 else None
    for sup in (False, True):
        kw = dict(percentile=0.5, interval=2, sup_level=sup)
        got = t_anc.prep_zmix5_store(setup["tstore"], inp, mesh=m, **kw)
        np.testing.assert_array_equal(
            got, t_anc.prep_zmix5_store(setup["tstore"], inp, **kw))
        if jm is not None:
            np.testing.assert_allclose(got, j_anc.prep_zmix5_store(
                setup["jstore"], jinp, mesh=jm, **kw), rtol=1e-14, atol=0)
    for level in ("population", "superpopulation"):
        kw = dict(percentile=0.5, interval=2, level=level)
        got = t_anc.zmix_store(setup["tstore"], inp, mesh=m, **kw)
        pd.testing.assert_frame_equal(
            got, t_anc.zmix_store(setup["tstore"], inp, **kw),
            check_exact=True)
        if jm is not None:
            pd.testing.assert_frame_equal(got, j_anc.zmix_store(
                setup["jstore"], jinp, mesh=jm, **kw), check_exact=True)
    eng = GenomeEngine(setup["tstore"], mesh=m)
    pd.testing.assert_frame_equal(
        eng.zmix(inp, percentile=0.5, interval=2),
        t_anc.zmix_store(setup["tstore"], inp, 0.5, 2), check_exact=True)


def test_pair_stats_match_gauss_tpu():
    import jax
    if len(jax.devices()) < 8:
        pytest.skip("needs gauss_tpu's 8 virtual devices")
    rng = np.random.default_rng(3)
    sizes = (13, 21, 9)
    G = rng.integers(0, 3, size=(30, sum(sizes)), dtype=np.int8)
    G_l, _, locs = t_mesh.subject_shard_layout(G, sizes, 4)
    got = t_mesh.build_sharded_pair_stats(locs, cpu_mesh(2, 4))(G_l)
    ref = j_mesh.build_sharded_pair_stats(locs, j_mesh.make_mesh(2, 4))(G_l)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


# -- meshes and engines refused ---------------------------------------------

def test_make_mesh_refusals():
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 2 devices, have 0"):
            t_mesh.make_mesh(1, 2)
    with pytest.raises(ValueError, match="need 4 devices, have 2"):
        t_mesh.make_mesh(2, 2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="mix device types"):
        t_mesh.make_mesh(1, 2, devices=["cpu", torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="no device"):
        t_mesh.make_mesh(0, 2, devices=["cpu"])
    m = cpu_mesh(2, 3)
    assert m.shape == {"window": 2, "subject": 3}
    assert m.axis_names == ("window", "subject")
    assert m.distinct() == [torch.device("cpu")]
    assert all(d == torch.device("cpu") for d in m.devices.ravel())


def test_engine_takes_one_of_device_and_mesh(setup):
    with pytest.raises(ValueError, match="exactly one"):
        GenomeEngine(setup["tstore"])
    with pytest.raises(ValueError, match="exactly one"):
        GenomeEngine(setup["tstore"], "cpu", mesh=cpu_mesh(1, 2))
    eng = GenomeEngine(setup["tstore"], mesh=cpu_mesh(1, 2))
    assert eng.device_linalg and eng.device == torch.device("cpu")
    run = _prepare(eng, "mix", setup["inp"])
    with pytest.raises(ValueError, match="subject shards"):
        run._device_panel()


def test_dryrun_multichip_on_the_cpu():
    """entry.dryrun_multichip(8) on a repeated CPU: a 2x4 mesh against the
    engine on one device, every path within its bound."""
    out = entry.dryrun_multichip(8, "cpu")
    assert set(out) == {"dz", "dinfo", "dz_runner", "dqcat_chisq", "dld",
                        "dchisq_genes", "dw_zmix"}
    assert out["dchisq_genes"] == 0.0 and out["dw_zmix"] == 0.0


# -- on the card --------------------------------------------------------------

def _gpu_pair(setup, devices, shape):
    one = GenomeEngine(setup["tstore"], devices[0], device_linalg=True)
    mesh = GenomeEngine(setup["tstore"], mesh=t_mesh.make_mesh(
        *shape, devices=devices))
    return (_prepare(one, "mix", setup["inp"]),
            _prepare(mesh, "mix", setup["inp"]))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mesh_on_one_card(setup, shape):
    """A mesh over a repeated cuda:0 against the engine on cuda:0: K1 and
    K2 launch once per shard, 1x1 bit-equal, the others within the bar."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gauss_tpu_torch.ops import gather, gram
    n = shape[0] * shape[1]
    one, mesh = _gpu_pair(setup, [torch.device("cuda", 0)] * n, shape)
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    ref = one.impute_region(lo, hi, **kw)
    mesh.impute_region(lo, hi, **kw)            # builds the batch
    gram.launches = gather.launches = 0
    got = mesh.impute_region(lo, hi, **kw)
    assert gram.launches == 2 * n and gather.launches == 0
    _same_rows(got, ref)
    for col in ("z", "info"):
        _close(got, ref, col, shape == (1, 1), **Z_BAR)
    q1 = one.qcat_region(lo, hi, **kw)
    qm = mesh.qcat_region(lo, hi, **kw)
    _same_rows(qm, q1, ("rsid", "bp", "type", "qcat_m"))
    _close(qm, q1, "qcat_t", shape == (1, 1), **QT_BAR)


def _distinct_cards(setup, shape):
    """A mesh over distinct cards against the engine on cuda:0: the row
    sums, the T1 partials and the gene partials cross between cards, each
    window group's output comes from its own lead card."""
    n = shape[0] * shape[1]
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards")
    devs = [torch.device("cuda", i) for i in range(n)]
    one, mesh = _gpu_pair(setup, devs, shape)
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    ref = one.impute_region(lo, hi, **kw)
    got = mesh.impute_region(lo, hi, **kw)
    _same_rows(got, ref)
    for col in ("z", "info"):
        _close(got, ref, col, False, **Z_BAR)
    q1, qm = (r.qcat_region(lo, hi, **kw) for r in (one, mesh))
    _same_rows(qm, q1, ("rsid", "bp", "type", "qcat_m"))
    _close(qm, q1, "qcat_t", False, **QT_BAR)
    for a, b in zip(mesh.ld_region(lo, hi, window_bp=kw["window_bp"]),
                    one.ld_region(lo, hi, window_bp=kw["window_bp"])):
        np.testing.assert_allclose(a["cormat"], b["cormat"], rtol=0,
                                   atol=LD_ATOL)
    b = mesh._region_batch(lo, hi, kw["window_bp"], kw["wing_size"])
    assert [g.inputs[0].device for g in b.groups] == \
        [devs[i * shape[1]] for i in range(shape[0])]


@pytest.mark.gpu
def test_mesh_on_two_cards(setup):
    """A (1 x 2) mesh over cuda:0 and cuda:1."""
    _distinct_cards(setup, (1, 2))


@pytest.mark.gpu
def test_mesh_on_four_cards(setup):
    """A (2 x 2) mesh over four cards: two window groups, each on its own
    pair."""
    _distinct_cards(setup, (2, 2))

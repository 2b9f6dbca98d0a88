"""The slice end to end: gauss_tpu_torch's GenomeEngine against
gauss_tpu's on the same panel and input.

Region tolerances are the JAX suite's own for f32 device solves
(tests/test_genome.py: z rtol 2e-4 / atol 1e-4, info rtol 2e-4 /
atol 2e-5); the float64 host paths agree to rtol 1e-10."""

import numpy as np
import pandas as pd
import pytest
import torch

from gauss_tpu.io import readers as j_readers
from gauss_tpu.models.genome import GenomeEngine as JEngine
from gauss_tpu.models.genome import PanelStore as JStore
from gauss_tpu_torch.config import PanelFiles
from gauss_tpu_torch.models.genome import GenomeEngine, PanelStore

POP_WGT = {"AAA": 0.5, "CCC": 0.3, "EEE": 0.2}
STUDY_POP = "BBB"


@pytest.fixture(scope="module")
def setup(synpanel, gwas_input):
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    inp = j_readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                                 wing_size=(hi - lo) // 3)
    kw = dict(window_bp=(hi - lo) // 3 + 1, wing_size=(hi - lo) // 3)
    jstore = JStore.from_bgzf(synpanel.files)
    tstore = PanelStore.from_bgzf(PanelFiles(
        synpanel.files.index_file, synpanel.files.data_file,
        synpanel.files.pop_desc_file))
    return dict(inp=inp, lo=lo, hi=hi, kw=kw, jstore=jstore, tstore=tstore)


def _prepare(engine, kind, inp):
    if kind == "mix":
        return engine.prepare_mix(inp, POP_WGT, af1_cutoff=0.01)
    return engine.prepare_homog(inp, STUDY_POP, af1_cutoff=0.01)


def _runs(setup, kind, device_linalg=True, device="cpu"):
    j = JEngine(setup["jstore"], snp_bucket=64, device_linalg=device_linalg,
                region_mode="resident")
    t = GenomeEngine(setup["tstore"], device, device_linalg=device_linalg)
    return _prepare(j, kind, setup["inp"]), _prepare(t, kind, setup["inp"])


def _assert_region_close(df_t, df_j):
    assert len(df_t) == len(df_j) > 0
    np.testing.assert_array_equal(df_t["rsid"].to_numpy(),
                                  df_j["rsid"].to_numpy())
    np.testing.assert_array_equal(df_t["type"].to_numpy(),
                                  df_j["type"].to_numpy())
    imp = df_j["type"].to_numpy() == 0
    assert imp.sum() > 0 and (~imp).sum() > 0
    for col in ("z", "info", "pval"):
        np.testing.assert_array_equal(df_t[col].to_numpy()[~imp],
                                      df_j[col].to_numpy()[~imp])
    np.testing.assert_allclose(df_t["z"].to_numpy()[imp],
                               df_j["z"].to_numpy()[imp],
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(df_t["info"].to_numpy()[imp],
                               df_j["info"].to_numpy()[imp],
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("kind", ["mix", "homog"])
def test_prepared_state_equals_jax(setup, kind):
    j, t = _runs(setup, kind)
    pd.testing.assert_frame_equal(t.table, j.table)
    np.testing.assert_array_equal(t.g_row, j.g_row)
    np.testing.assert_array_equal(t.subj_cols, j.subj_cols)
    assert t.pop_sizes == j.pop_sizes
    assert t.wgts == j.wgts


@pytest.mark.parametrize("kind", ["mix", "homog"])
def test_region_matches_jax_resident(setup, kind):
    j, t = _runs(setup, kind)
    df_j = j.impute_region(setup["lo"], setup["hi"], **setup["kw"])
    df_t = t.impute_region(setup["lo"], setup["hi"], **setup["kw"])
    _assert_region_close(df_t, df_j)
    assert list(df_t.columns) == list(df_j.columns)


@pytest.mark.parametrize("kind", ["mix", "homog"])
def test_host_window_matches_jax_host_path(setup, kind):
    j, t = _runs(setup, kind, device_linalg=False)
    lo, hi = setup["lo"], setup["hi"]
    span = ((hi - lo) // 3 + lo, 2 * (hi - lo) // 3 + lo)
    a = j.impute_window(*span, (hi - lo) // 4).table
    b = t.impute_window(*span, (hi - lo) // 4).table
    assert len(a) == len(b) > 0
    np.testing.assert_array_equal(b["rsid"].to_numpy(), a["rsid"].to_numpy())
    for col in ("z", "info", "pval"):
        np.testing.assert_allclose(b[col].to_numpy(), a[col].to_numpy(),
                                   rtol=1e-10, atol=1e-12)
    # the host region path is the same windows, one by one
    np.testing.assert_allclose(
        t.impute_region(lo, hi, **setup["kw"])["z"].to_numpy(),
        j.impute_region(lo, hi, **setup["kw"])["z"].to_numpy(),
        rtol=1e-10, atol=1e-12)


def test_region_device_path_tracks_host_path(setup):
    """The f32 region kernel against the port's own f64 host path on one
    window (the chip_smoke parity check at test size)."""
    _, t = _runs(setup, "mix")
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    region = t.impute_region(lo, hi, **kw)
    first = region[region["bp"] <= lo + kw["window_bp"] - 1]
    host = t._impute_window_host(lo, lo + kw["window_bp"] - 1,
                                 kw["wing_size"])
    imp = host.table["type"].to_numpy() == 0
    np.testing.assert_allclose(first["z"].to_numpy()[imp],
                               host.table["z"].to_numpy()[imp],
                               rtol=2e-4, atol=1e-4)


def test_impute_regions_pipelined_equals_sequential(setup):
    _, t = _runs(setup, "mix")
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    mid = (lo + hi) // 2
    spans = [(lo, mid), (mid + 1, hi), (lo, hi), (lo, mid)]
    seq = [t.impute_region(a, b, **kw) for a, b in spans]
    got = list(t.impute_regions(spans, depth=2, **kw))
    assert [(a, b) for a, b, _ in got] == spans
    for (_, _, df), ref in zip(got, seq):
        pd.testing.assert_frame_equal(df, ref)
    # only the newest aligned batch stays cached
    batches = [k for k in t._res if isinstance(k, tuple) and k[0] == "batch"]
    assert len(batches) == 1


def test_shared_layout_fallback_gives_same_output(setup, monkeypatch):
    _, aligned = _runs(setup, "mix")
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    ref = aligned.impute_region(lo, hi, **kw)
    assert "arrays" not in aligned._res
    monkeypatch.setenv("GAUSS_ALIGNED_MAX_BYTES", "1")
    _, shared = _runs(setup, "mix")
    got = shared.impute_region(lo, hi, **kw)
    assert "arrays" in shared._res           # the shared layout was built
    pd.testing.assert_frame_equal(got.drop(columns=["z", "info", "pval"]),
                                  ref.drop(columns=["z", "info", "pval"]))
    for col in ("z", "info"):
        np.testing.assert_allclose(got[col].to_numpy(), ref[col].to_numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_empty_region_and_async_guard(setup):
    j, t = _runs(setup, "mix")
    assert t.impute_region(1, 10, **setup["kw"]).empty
    _, host = _runs(setup, "mix", device_linalg=False)
    with pytest.raises(ValueError):
        host.impute_region_async(setup["lo"], setup["hi"], **setup["kw"])


@pytest.mark.gpu
def test_region_on_a_non_current_device(setup):
    """An engine on cuda:1 while cuda:0 is current: the kernels, the
    tail and the pinned copy of the output all run on cuda:1's stream,
    and RegionHandle.result() must wait on that stream."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    ref = _runs(setup, "mix")[1].impute_region(lo, hi, **kw)
    torch.cuda.set_device(0)
    t = _runs(setup, "mix", device="cuda:1")[1]
    # another span first: it uploads the tail's constants (a pageable
    # copy, which waits for the stream) and leaves other values in the
    # pinned buffers; then only the span's launches follow the sleep
    t.impute_region(lo, (lo + hi) // 2, **kw)
    t._region_batch(lo, hi, kw["window_bp"], kw["wing_size"])
    with torch.cuda.device(1):
        torch.cuda._sleep(500_000_000)     # hold cuda:1's stream busy
    got = t.impute_region(lo, hi, **kw)
    assert torch.cuda.current_device() == 0
    _assert_region_close(got, ref)


# -- the single-window device path -----------------------------------------

def _windows(setup):
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    spans, a = [], lo
    while a <= hi:
        spans.append((a, min(a + kw["window_bp"] - 1, hi)))
        a = spans[-1][1] + 1
    return spans


@pytest.mark.parametrize("kind", ["mix", "homog"])
def test_device_window_matches_jax_device_window(setup, kind):
    """impute_window with device_linalg: a one-window region through the
    resident kernel, against gauss_tpu's device impute_window (its gather
    window kernel) on every window, at the region bar above."""
    j, t = _runs(setup, kind)
    wing = setup["kw"]["wing_size"]
    for span in _windows(setup):
        a, b = j.impute_window(*span, wing), t.impute_window(*span, wing)
        assert (a.n_measured, a.n_unmeasured) == (b.n_measured,
                                                  b.n_unmeasured)
        _assert_region_close(b.table, a.table)
        assert list(b.table.columns) == list(a.table.columns)
    assert j.impute_window(1, 10, wing) is None
    assert t.impute_window(1, 10, wing) is None


def test_device_window_equals_its_rows_of_the_region(setup):
    """The same window alone and inside a region call: the same rows
    through the same kernels, at other padded band heights, so the f32
    factorizations differ in their last bits (rtol = atol = 1e-5 on this
    225-subject panel, a tenth of the bar against gauss_tpu); both track
    the float64 host window."""
    _, t = _runs(setup, "mix")
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    region = t.impute_region(lo, hi, **kw)
    for a, b in _windows(setup):
        alone = t.impute_window(a, b, kw["wing_size"]).table
        inside = region[(region["bp"] >= a) & (region["bp"] <= b)
                        ].reset_index(drop=True)
        pd.testing.assert_frame_equal(
            alone.drop(columns=["z", "info", "pval"]),
            inside.drop(columns=["z", "info", "pval"]))
        for col in ("z", "info"):
            np.testing.assert_allclose(alone[col].to_numpy(),
                                       inside[col].to_numpy(),
                                       rtol=1e-5, atol=1e-5)
        host = t._impute_window_host(a, b, kw["wing_size"]).table
        _assert_region_close(alone, host)


def test_device_windows_leave_the_region_batch_cached(setup):
    """Single windows are cached apart from region batches: a loop over
    windows between two calls on a region keeps the region's batch (the
    same object, not rebuilt) and holds one window's batch at a time."""
    _, t = _runs(setup, "mix")
    lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
    t.impute_region(lo, hi, **kw)
    batch = t._region_batch(lo, hi, kw["window_bp"], kw["wing_size"])
    for span in _windows(setup):
        t.impute_window(*span, kw["wing_size"])
    assert t._region_batch(lo, hi, kw["window_bp"],
                           kw["wing_size"]) is batch
    for slot, n in (("batch", 1), ("window", 1), ("batch asm", 1),
                    ("window asm", 1)):
        assert len([k for k in t._res if isinstance(k, tuple)
                    and k[0] == slot]) == n


def test_host_engine_window_is_the_float64_path(setup):
    _, t = _runs(setup, "mix", device_linalg=False)
    a, b = _windows(setup)[1]
    pd.testing.assert_frame_equal(
        t.impute_window(a, b, setup["kw"]["wing_size"]).table,
        t._impute_window_host(a, b, setup["kw"]["wing_size"]).table)
    assert not [k for k in t._res if k[0] == "batch"]


# -- the reference's other device paths, held to the one resident path ----

@pytest.mark.parametrize("kind", ["mix", "homog"])
@pytest.mark.parametrize("stats,region_mode", [
    ("pallas", "gather"), ("int8", "gather"), ("centered", "gather"),
    ("int8", "auto"), ("centered", "auto")])
def test_region_matches_jax_gather_paths(setup, kind, stats, region_mode):
    """gauss_tpu's gather-path region kernels (build_region_kernel over
    _pallas_weighted_stats / _int8_weighted_stats / the centered
    window_corr_blocks) give what the port's one resident path gives, at
    the region bar above: none of them needs a port of its own."""
    j = JEngine(setup["jstore"], snp_bucket=64, device_linalg=True,
                stats=stats, region_mode=region_mode)
    t = GenomeEngine(setup["tstore"], "cpu", device_linalg=True)
    df_j = _prepare(j, kind, setup["inp"]).impute_region(
        setup["lo"], setup["hi"], **setup["kw"])
    df_t = _prepare(t, kind, setup["inp"]).impute_region(
        setup["lo"], setup["hi"], **setup["kw"])
    _assert_region_close(df_t, df_j)


# -- TF32 stays the caller's -------------------------------------------------

@pytest.mark.parametrize("before", [True, False])
def test_engine_leaves_the_tf32_switches_alone(setup, before):
    """Building an engine and running every resident kernel leaves both
    TF32 switches as the caller set them; inside the kernels they are
    off."""
    from gauss_tpu_torch.ops import window_kernel as wk
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    inside = []
    real = wk._by_slab

    def spy(*a, **k):
        inside.append(flags())
        return real(*a, **k)

    try:
        torch.backends.cuda.matmul.allow_tf32 = before
        torch.backends.cudnn.allow_tf32 = before
        wk._by_slab = spy
        _, t = _runs(setup, "mix")
        assert flags() == (before, before)
        lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
        assert len(t.impute_region(lo, hi, **kw))
        assert len(t.qcat_region(lo, hi, **kw))
        assert len(t.ld_region(lo, hi, window_bp=kw["window_bp"]))
        assert t.impute_window(lo, lo + kw["window_bp"] - 1,
                               kw["wing_size"]) is not None
        assert flags() == (before, before)
        assert inside == [(False, False)] * 4
        with pytest.raises(ZeroDivisionError):     # restored on an error
            with wk.full_f32_matmul():
                assert flags() == (False, False)
                1 / 0
        assert flags() == (before, before)
    finally:
        wk._by_slab = real
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.gpu
def test_region_on_gpu_meets_the_bar_with_tf32_on(setup):
    """allow_tf32 = True in the caller: impute_region on the card still
    agrees with the float64 host window to 1e-5 in z (the tail's matmuls
    run in full f32), and the switch is still on afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        t = _runs(setup, "mix", device="cuda")[1]
        lo, hi, kw = setup["lo"], setup["hi"], setup["kw"]
        region = t.impute_region(lo, hi, **kw)
        assert torch.backends.cuda.matmul.allow_tf32 is True
        for a, b in _windows(setup):
            host = t._impute_window_host(a, b, kw["wing_size"]).table
            got = region[(region["bp"] >= a) & (region["bp"] <= b)]
            imp = host["type"].to_numpy() == 0
            np.testing.assert_allclose(got["z"].to_numpy()[imp],
                                       host["z"].to_numpy()[imp],
                                       rtol=0, atol=1e-5)
            alone = t.impute_window(a, b, kw["wing_size"]).table
            np.testing.assert_allclose(alone["z"].to_numpy()[imp],
                                       host["z"].to_numpy()[imp],
                                       rtol=0, atol=1e-5)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# -- small carried-over pieces --------------------------------------------

def test_panel_store_from_arrays(setup):
    s = setup["tstore"]
    a = PanelStore.from_arrays(s.index, s.G, s.af, s.desc)
    b = JStore.from_arrays(s.index, s.G, s.af, s.desc)
    assert isinstance(a, PanelStore)
    for x in (a, b):
        assert x.index is s.index and x.G is s.G and x.af is s.af \
            and x.desc is s.desc


def test_entry_matches_jax_entry():
    """entry(device): the resident impute kernel on the toy windows of
    the repo's JAX entry module, against its window kernel on the
    same blocks (real rows; f32 solves at toy size)."""
    import __graft_entry__ as j_entry
    from gauss_tpu_torch import entry as t_entry
    for a, b in zip(t_entry._toy_window(), j_entry._toy_window()):
        np.testing.assert_array_equal(a, b)
    fn, args = t_entry.entry("cpu")
    assert all(x.device.type == "cpu" for x in args)
    out = fn(*args).numpy()
    jfn, jargs = j_entry.entry()
    z, info = (np.asarray(x) for x in jfn(*jargs))
    U = 16 - 2                                     # the toy's real rows
    assert out.shape[:2] == (2, 2) and z.shape == (2, 16)
    np.testing.assert_allclose(out[0][:, :U], z[:, :U], rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(out[1][:, :U], info[:, :U], rtol=2e-4,
                               atol=2e-5)

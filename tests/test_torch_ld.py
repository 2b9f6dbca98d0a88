"""LD on gauss_tpu_torch's genome engine (PreparedRun.ld_region /
ld_window, the resident LD kernel, the int16 packing) against gauss_tpu
on the same panel and input.

Tolerances:
* ld_region f32 vs gauss_tpu's resident LD: 5e-5, the JAX suite's own
  bound between two f32 LD kernels (tests/test_genome.py); i16tri:
  2 * LD_I16_MAX_ERR (each side quantizes its own f32 value).
* ld_window vs gauss_tpu's ld_window and the float64 compute_ld:
  rtol = atol = 2e-4, the JAX suite's bound for f32 device LD against
  the host path.
* the int16 quantization and the unpacker: bit-equal, NaN where NaN.
* the expansion on the device (window_kernel.expand_ld), ld_region and
  ld_window against the host formulas they replaced (unpack_tri_i16,
  _dequant_i16, the f32 cast) on the same correlations: bit-equal, NaN
  where NaN; the one-pass window tiling against the per-window loop:
  equal.
* a CUDA card against the CPU's plain versions: 5e-5 in f32 (K1's f32
  fold vs the plain float64 sum, and the tail's f32 rounding order)."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import gauss_tpu
from gauss_tpu.io import readers as j_readers
from gauss_tpu.models.genome import GenomeEngine as JEngine
from gauss_tpu.models.genome import PanelStore as JStore
from gauss_tpu.ops import window_kernel as jwk
from gauss_tpu_torch.config import PanelFiles
from gauss_tpu_torch.models.genome import GenomeEngine, PanelStore
from gauss_tpu_torch.ops import gather, gram
from gauss_tpu_torch.ops import window_kernel as twk

POP_WGT = pd.DataFrame({"pop": ["AAA", "CCC", "EEE"],
                        "wgt": [0.5, 0.3, 0.2]})
MAX_ERR = twk.LD_I16_MAX_ERR


@pytest.fixture(scope="module")
def setup(synpanel, gwas_input):
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    inp = j_readers.read_input_z(path, chrom=22, start_bp=lo, end_bp=hi,
                                 wing_size=0)
    jstore = JStore.from_bgzf(synpanel.files)
    tstore = PanelStore.from_bgzf(PanelFiles(
        synpanel.files.index_file, synpanel.files.data_file,
        synpanel.files.pop_desc_file))
    pop_wgt = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    return dict(inp=inp, lo=lo, hi=hi, jstore=jstore, tstore=tstore,
                pop_wgt=pop_wgt, path=path, files=synpanel.files)


def _torch_run(setup, device="cpu"):
    return GenomeEngine(setup["tstore"], device).prepare_mix(
        setup["inp"], setup["pop_wgt"], af1_cutoff=0.01)


def _jax_run(setup):
    return JEngine(setup["jstore"], snp_bucket=64, device_linalg=True,
                   region_mode="resident").prepare_mix(
        setup["inp"], setup["pop_wgt"], af1_cutoff=0.01)


def _assert_ld_close(got, ref, tol):
    assert len(got) == len(ref) > 1
    for x, y in zip(got, ref):
        pd.testing.assert_frame_equal(x["snplist"], y["snplist"])
        assert x["fetch"] == y["fetch"]
        assert x["cormat"].dtype == np.float64
        assert x["cormat"].shape == y["cormat"].shape
        np.testing.assert_array_equal(np.diag(x["cormat"]), 1.0)
        d = np.abs(x["cormat"] - y["cormat"]).max()
        assert d <= tol, (x["fetch"], d)


@pytest.mark.parametrize("fetch,tol", [("f32", 5e-5),
                                       ("i16tri", 2 * MAX_ERR)])
def test_ld_region_matches_jax_resident(setup, fetch, tol):
    lo, hi = setup["lo"], setup["hi"]
    wbp = (hi - lo) // 3
    got = _torch_run(setup).ld_region(lo, hi, window_bp=wbp, fetch=fetch)
    ref = _jax_run(setup).ld_region(lo, hi, window_bp=wbp, fetch=fetch)
    _assert_ld_close(got, ref, tol)


def test_ld_region_default_is_i16tri_within_bound(setup):
    run = _torch_run(setup)
    lo, hi = setup["lo"], setup["hi"]
    wbp = (hi - lo) // 4
    f32 = run.ld_region(lo, hi, window_bp=wbp, fetch="f32")
    for fetch in ("i16tri", "i16full"):
        q = (run.ld_region(lo, hi, window_bp=wbp) if fetch == "i16tri"
             else run.ld_region(lo, hi, window_bp=wbp, fetch=fetch))
        assert [d["fetch"] for d in q] == [fetch] * len(f32)
        for a, b in zip(q, f32):
            np.testing.assert_array_equal(a["cormat"], a["cormat"].T)
            np.testing.assert_array_equal(np.diag(a["cormat"]), 1.0)
            assert np.abs(a["cormat"] - b["cormat"]).max() <= MAX_ERR
    # LD reads only the measured half of the shared layout
    assert ("half", 1) in run._res and ("half", 0) not in run._res


def test_ld_window_matches_jax_and_compute_ld(setup):
    lo, hi = setup["lo"], setup["hi"]
    mid = lo + (hi - lo) // 2
    got = _torch_run(setup).ld_window(lo, mid)
    assert got["fetch"] == "f32"
    ref = JEngine(setup["jstore"], snp_bucket=64, device_linalg=True
                  ).prepare_mix(setup["inp"], setup["pop_wgt"],
                                af1_cutoff=0.01).ld_window(lo, mid)
    f = setup["files"]
    host = gauss_tpu.compute_ld(22, lo, mid, POP_WGT, setup["path"],
                                f.index_file, f.data_file, f.pop_desc_file,
                                af1_cutoff=0.01)
    pd.testing.assert_frame_equal(got["snplist"], ref["snplist"])
    assert list(got["snplist"]["rsid"]) == list(host["snplist"]["rsid"])
    for other in (ref["cormat"], host["cormat"]):
        np.testing.assert_allclose(got["cormat"], other, rtol=2e-4,
                                   atol=2e-4)


def _nan_matrix(seed=5, n=70):
    """A symmetric f32 correlation-like matrix with NaN rows, exact
    half-unit products (round half to even) and values past +-1."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-1.0, 1.0, (n, n)).astype(np.float32)
    A = (A + A.T) / np.float32(2.0)
    np.fill_diagonal(A, 1.0)
    A[3, :] = A[:, 3] = np.nan
    A[10, 11] = A[11, 10] = np.float32(2.5 / 32767.0)
    A[12, 13] = A[13, 12] = np.float32(1.0000001)
    A[14, 15] = A[15, 14] = np.float32(-1.5)
    return A


def test_quantization_and_unpack_match_jax():
    A = _nan_matrix()
    n = A.shape[0]
    qa = np.asarray(jwk._quant_i16(jnp.asarray(A)))
    qb = twk._quant_i16(torch.from_numpy(A)).numpy()
    assert qb.dtype == np.int16
    np.testing.assert_array_equal(qb, qa)
    ta = np.asarray(jwk.pack_tri_i16(jnp.asarray(A)))
    tb = twk.pack_tri_i16(torch.from_numpy(A)).numpy()
    np.testing.assert_array_equal(tb, ta)
    for M in (n, 40, 1):
        ua = jwk.unpack_tri_i16(ta, n, M)
        ub = twk.unpack_tri_i16(tb, n, M)
        np.testing.assert_array_equal(np.isnan(ub), np.isnan(ua))
        np.testing.assert_array_equal(ub, ua)
    np.testing.assert_array_equal(twk._dequant_i16(qb),
                                  jwk._dequant_i16(qa))
    # batched packing: one row per window
    Ab = np.stack([A, _nan_matrix(6)])
    np.testing.assert_array_equal(
        twk.pack_tri_i16(torch.from_numpy(Ab)).numpy(),
        np.asarray(jwk.pack_tri_i16(jnp.asarray(Ab))))


def _same_bits(got, ref):
    """float64 arrays of one shape with NaN where NaN and the same bits
    everywhere else."""
    assert got.dtype == ref.dtype == np.float64
    assert got.shape == ref.shape
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got.view(np.uint64)[~nan],
                                  ref.view(np.uint64)[~nan])


def _host_formula(corr, Mp, sizes, fetch):
    """The windows' matrices as the host made them from the kernel's raw
    output before the expansion moved to the device: one int16 triangle
    per window unpacked, the mirrored int16 matrix dequantized, or the
    f32 block cast."""
    if fetch == "i16tri":
        raw = twk.pack_tri_i16(corr).numpy()
        return [twk.unpack_tri_i16(raw[w], Mp, M)
                for w, M in enumerate(sizes)]
    if fetch == "i16full":
        raw = twk._quant_i16(gram.mirror_lower(corr)).numpy()
        return [twk._dequant_i16(raw[w, :M, :M]) for w, M in enumerate(sizes)]
    raw = corr.numpy()
    return [raw[w, :M, :M].astype(np.float64) for w, M in enumerate(sizes)]


def _split(flat, sizes):
    out, off = [], 0
    for M in sizes:
        out.append(flat[off:off + M * M].reshape(M, M))
        off += M * M
    assert off == flat.size
    return out


@pytest.mark.parametrize("fetch", twk.LD_FETCH)
def test_expand_ld_matches_host_unpack(fetch):
    """The device expansion, run on the CPU, against the host formulas,
    one window at M in (n, 40, 1) and a batch of windows of different M
    (one of size 0, a padding window) whose upper triangles differ from
    their lower ones (the int16 forms read the lower triangle only)."""
    A = _nan_matrix()
    n = A.shape[0]
    for M in (n, 40, 1):
        corr = torch.from_numpy(A)[None]
        got = twk.expand_ld(corr, (M,), fetch).numpy()
        _same_bits(got.reshape(M, M), _host_formula(corr, n, (M,), fetch)[0])
    rng = np.random.default_rng(8)
    B = _nan_matrix(6)
    iu = np.triu_indices(n, 1)
    B[iu] = rng.uniform(-1.0, 1.0, len(iu[0])).astype(np.float32)
    corr = torch.from_numpy(np.stack([B, A, _nan_matrix(7), B]))
    sizes = (n, 23, 0, 1)
    got = twk.expand_ld(corr, sizes, fetch)
    assert got.dtype == torch.float64 and got.is_contiguous()
    for g, r in zip(_split(got.numpy(), sizes),
                    _host_formula(corr, n, sizes, fetch)):
        _same_bits(g, r)
    if fetch != "f32":          # the unpacker's values: exact unit
        np.testing.assert_array_equal(   # diagonal, NaN rows kept
            np.diag(_split(got.numpy(), sizes)[1]), [1.0] * 3
            + [np.nan] + [1.0] * 19)
    with pytest.raises(ValueError):
        twk.expand_ld(corr, (n, 23, 0), fetch)
    with pytest.raises(ValueError):
        twk.expand_ld(corr, (n, 23, 0, n + 1), fetch)


@pytest.mark.parametrize("fetch", twk.LD_FETCH)
def test_ld_region_bits_match_host_formula(setup, fetch):
    """ld_region and ld_window return the windows, snplist frames and
    cormat bits that the host made from the kernel's raw output before
    the expansion moved to the device; every cormat a C-contiguous
    float64 matrix."""
    run = _torch_run(setup)
    lo, hi = setup["lo"], setup["hi"]
    wbp = (hi - lo) // 3
    windows = run._ld_windows(lo, hi, wbp)
    fn, args, Mp = run._ld_batch(windows, fetch)
    assert len(args) == 6 and args[5][:len(windows)] == tuple(
        len(r) for r in windows)
    corr = twk.build_resident_ld_corr(
        run.engine._spec(run.pop_sizes, run.wgts), Mp)(*args[:5])
    sizes = [len(r) for r in windows]
    ref = _host_formula(corr, Mp, sizes, fetch)
    got = run.ld_region(lo, hi, window_bp=wbp, fetch=fetch)
    assert len(got) == len(windows) > 1
    t = run.table
    for d, m_rows, r in zip(got, windows, ref):
        tt = t.iloc[m_rows]
        pd.testing.assert_frame_equal(d["snplist"], pd.DataFrame({
            c: tt[c].to_numpy() for c in ("rsid", "chr", "bp", "a1", "a2",
                                          "af1mix", "z")}))
        assert d["fetch"] == fetch
        assert d["cormat"].flags.c_contiguous
        _same_bits(d["cormat"], r)
    one = run.ld_window(lo, lo + wbp - 1, fetch=fetch)
    assert one["cormat"].flags.c_contiguous
    pd.testing.assert_frame_equal(one["snplist"], got[0]["snplist"])
    w1 = run._ld_windows(lo, lo + wbp - 1, wbp)
    _, a1, Mp1 = run._ld_batch(w1, fetch)
    c1 = twk.build_resident_ld_corr(
        run.engine._spec(run.pop_sizes, run.wgts), Mp1)(*a1[:5])
    _same_bits(one["cormat"], _host_formula(c1, Mp1, [len(w1[0])],
                                            fetch)[0])


def _ld_windows_loop(run, start_bp, end_bp, window_bp):
    """The per-window tiling that the one-pass search replaced."""
    bp = run.table["bp"].to_numpy()
    typ = run.table["type"].to_numpy()
    windows = []
    pos = start_bp
    while pos <= end_bp:
        hi = min(pos + window_bp - 1, end_bp)
        m_rows = np.flatnonzero((typ == 1) & (bp >= pos) & (bp <= hi))
        if len(m_rows):
            windows.append(m_rows)
        pos = hi + 1
    return windows


def test_ld_windows_one_pass_matches_loop(setup):
    run = _torch_run(setup)
    lo, hi = setup["lo"], setup["hi"]
    bp_m = run.table["bp"].to_numpy()[run.table["type"].to_numpy() == 1]
    gap = int(np.diff(bp_m).max())
    spans = [
        (lo, hi, (hi - lo) // 3),          # end_bp inside the last window
        (lo, hi, (hi - lo) // 4 + 1),
        (lo - 5_000, hi + 5_000, gap // 2),  # empty windows skipped
        (lo, hi, 1),                       # one-SNP windows
        (int(bp_m[7]), int(bp_m[7]), 1),   # a one-bp span on one SNP
        (int(bp_m[7]), int(bp_m[9]) - 1, 10_000_000),
        (int(bp_m[7]) + 1, int(bp_m[8]) - 1, 100),   # no measured SNP
        (hi + 1, hi + 1_000, 100),
        (hi, lo, 1_000),                   # end before start
    ]
    for a, b, w in spans:
        got = run._ld_windows(a, b, w)
        ref = _ld_windows_loop(run, a, b, w)
        assert len(got) == len(ref), (a, b, w)
        for x, y in zip(got, ref):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert [len(r) for r in run._ld_windows(lo, hi, 1)] == [1] * len(bp_m)
    with pytest.raises(ValueError):
        run._ld_windows(lo, hi, 0)


def test_ld_edge_cases(setup):
    lo, hi = setup["lo"], setup["hi"]
    run = _torch_run(setup)
    assert run.ld_window(1, 10) is None
    assert run.ld_region(1, 10) == []
    with pytest.raises(ValueError):
        run.ld_region(lo, hi, fetch="f16")
    pooled = GenomeEngine(setup["tstore"], "cpu").prepare_homog(
        setup["inp"], "EUR", af1_cutoff=0.01)
    with pytest.raises(ValueError):
        pooled.ld_region(lo, hi)
    with pytest.raises(ValueError):
        pooled.ld_window(lo, hi)
    with pytest.raises(ValueError):
        twk.build_resident_ld_kernel(
            GenomeEngine(setup["tstore"], "cpu")._spec((10, 20), None), 64)


@pytest.mark.gpu
@pytest.mark.parametrize("fetch,tol", [("f32", 5e-5),
                                       ("i16tri", 2 * MAX_ERR)])
def test_ld_region_on_gpu_matches_cpu(setup, fetch, tol):
    """The card path (K2 gathers the measured half, one K1 launch per
    slab) against the CPU's plain versions at the conftest size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lo, hi = setup["lo"], setup["hi"]
    wbp = (hi - lo) // 3
    ref = _torch_run(setup).ld_region(lo, hi, window_bp=wbp, fetch=fetch)
    gram.launches = gather.launches = 0
    got = _torch_run(setup, "cuda:0").ld_region(lo, hi, window_bp=wbp,
                                                fetch=fetch)
    assert gram.launches >= 1 and gather.launches >= 1
    _assert_ld_close(got, ref, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("fetch", twk.LD_FETCH)
def test_ld_region_on_gpu_expands_as_cpu(setup, fetch):
    """On the card, the device expansion of the card's own correlations
    gives the host formulas' bits (ld_region against
    build_resident_ld_corr's output through _host_formula, and against
    expand_ld on the CPU of those same correlations), and no returned
    cormat lies in pinned memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lo, hi = setup["lo"], setup["hi"]
    wbp = (hi - lo) // 3
    run = _torch_run(setup, "cuda:0")
    windows = run._ld_windows(lo, hi, wbp)
    _, args, Mp = run._ld_batch(windows, fetch)
    corr = twk.build_resident_ld_corr(
        run.engine._spec(run.pop_sizes, run.wgts), Mp)(*args[:5]).cpu()
    sizes = [len(r) for r in windows]
    ref = _host_formula(corr, Mp, sizes, fetch)
    cpu = _split(twk.expand_ld(corr, sizes, fetch).numpy(), sizes)
    got = run.ld_region(lo, hi, window_bp=wbp, fetch=fetch)
    assert len(got) == len(windows)
    for d, r, c in zip(got, ref, cpu):
        assert d["cormat"].flags.c_contiguous
        assert not torch.from_numpy(d["cormat"]).is_pinned()
        _same_bits(d["cormat"], r)
        _same_bits(d["cormat"], c)

"""Resident region kernel (gauss_tpu_torch.ops.window_kernel) against
gauss_tpu.ops.window_kernel on the same inputs, the JAX side's Pallas
Gram in interpret mode; the region tail's kernels (ops/region_tail)
through their plain versions against the CalWgtCov formulas in float64,
and on the card against those plain versions.

Tolerances: X_shift bit-equal (exact integer arithmetic on both sides);
Sp/Mu/V rel 1e-6 (f32 divisions / one f32 product with alpha); B11/B21
atol 1e-5 (f32 Grams and CalWgtCov tails summed in different orders);
z rtol 2e-4 / atol 1e-4 and info rtol 2e-4 / atol 2e-5, the JAX suite's
own bounds for f32 Cholesky + triangular solves of different algorithms
(blocked on the JAX side, LAPACK here)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.models.genome import PanelStore as JStore
from gauss_tpu.ops import pallas_gram as pg
from gauss_tpu.ops import window_kernel as jwk
from gauss_tpu_torch.core.stats import full_f32_matmul
from gauss_tpu_torch.ops import _build, gram, region_tail
from gauss_tpu_torch.ops import window_kernel as twk

R = pg.ROW_TILE          # 256: the JAX kernel's row tile; also fine here
W = 2
MP = UP = R


@pytest.fixture(scope="module")
def panel(synpanel):
    store = JStore.from_bgzf(synpanel.files)
    sizes = tuple(int(s) for s in store.desc.sizes)
    Gp, padded = jwk.pad_pop_segments(store.G, sizes, multiple=pg.K_TILE)
    return store.G, Gp, sizes, padded


def _specs(sizes, padded, weighted):
    wgts = (0.3, 0.1, 0.25, 0.15, 0.2) if weighted else None
    return (jwk.WindowKernelSpec(pop_sizes=sizes, pop_sizes_padded=padded,
                                 wgts=wgts),
            twk.WindowKernelSpec(pop_sizes=sizes, pop_sizes_padded=padded,
                                 wgts=wgts))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1.0)


def _prepare_both(Gp, rows, n_rows, js, ts):
    a = jwk.prepare_resident_panel(jnp.asarray(Gp), jnp.asarray(rows),
                                   n_rows, js)
    b = twk.prepare_resident_panel(torch.from_numpy(Gp),
                                   torch.from_numpy(rows), n_rows, ts)
    return [np.asarray(x) for x in a], [x.numpy() for x in b]


def test_pad_pop_segments_matches(panel):
    G, Gp, sizes, padded = panel
    got, got_padded = twk.pad_pop_segments(G, sizes, multiple=pg.K_TILE)
    assert got_padded == padded
    np.testing.assert_array_equal(got, Gp)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("sentinel", [True, False])
def test_prepare_resident_panel_matches(panel, weighted, sentinel):
    G, Gp, sizes, padded = panel
    rng = np.random.default_rng(11)
    rows = rng.integers(0, G.shape[0], 2 * R).astype(np.int32)
    if sentinel:
        rows[rng.random(2 * R) < 0.25] = -1
        n_rows = None
    else:
        n_rows = 300
    js, ts = _specs(sizes, padded, weighted)
    (xa, spa, mua, va), (xb, spb, mub, vb) = _prepare_both(Gp, rows, n_rows,
                                                           js, ts)
    assert xb.dtype == np.int8 and xb.shape == (2 * R, sum(padded))
    np.testing.assert_array_equal(xb, xa)
    P = len(sizes) if weighted else 1
    assert spb.shape == mub.shape == (2 * R, P) and vb.shape == (2 * R,)
    for x, y in ((spb, spa), (mub, mua), (vb, va)):
        assert x.dtype == np.float32
        assert _rel(x, y) < 1e-6


def _region_inputs(G, Gp, sizes, padded, weighted, seed=12):
    """Aligned two-window batch: window w's measured rows fill band w of
    Xm (MP rows) and its unmeasured rows band w of Xu (UP rows); the
    rest are -1 sentinels."""
    rng = np.random.default_rng(seed)
    Ms, Us = (200, 180), (150, 100)
    rows_m = np.full(W * MP, -1, np.int32)
    rows_u = np.full(W * UP, -1, np.int32)
    m_mask = np.zeros((W, MP), np.float32)
    u_mask = np.zeros((W, UP), np.float32)
    Z1 = np.zeros((W, MP), np.float32)
    for w in range(W):
        rows_m[w * MP:w * MP + Ms[w]] = np.sort(rng.choice(
            G.shape[0], Ms[w], replace=False))
        rows_u[w * UP:w * UP + Us[w]] = rng.choice(G.shape[0], Us[w])
        m_mask[w, :Ms[w]] = 1
        u_mask[w, :Us[w]] = 1
        Z1[w, :Ms[w]] = rng.standard_normal(Ms[w]) * 1.5
    js, ts = _specs(sizes, padded, weighted)
    a_m, b_m = _prepare_both(Gp, rows_m, None, js, ts)
    a_u, b_u = _prepare_both(Gp, rows_u, None, js, ts)
    jx = (a_m[0], a_u[0], a_m[1], a_u[1], a_m[2], a_u[2], a_u[3])
    tx = (b_m[0], b_u[0], b_m[1], b_u[1], b_m[2], b_u[2], b_u[3])
    tiles = np.arange(W, dtype=np.int32)
    j_in = [jnp.asarray(x) for x in jx + (tiles, tiles)]
    t_in = [torch.from_numpy(x) for x in tx + (tiles * MP, tiles * UP)]
    return js, ts, j_in, t_in, (Z1, m_mask, u_mask)


@pytest.mark.parametrize("weighted", [True, False])
def test_block_builder_matches(panel, weighted):
    """B11 and the right-hand side [B21^T | Z1] against JAX's (B11, B21)
    and the Z1 they were given."""
    G, Gp, sizes, padded = panel
    js, ts, j_in, t_in, (z1, m_mask, u_mask) = _region_inputs(
        G, Gp, sizes, padded, weighted)
    a11, a21 = jwk._resident_block_builder(js, MP, UP)(
        *j_in, jnp.asarray(m_mask), jnp.asarray(u_mask))
    b11, rhs = twk._ResidentBlocks(ts, MP, UP)(
        *t_in, torch.from_numpy(z1), torch.from_numpy(m_mask),
        torch.from_numpy(u_mask))
    assert b11.shape == (W, MP, MP) and rhs.shape == (W, MP, UP + 1)
    assert b11.dtype == rhs.dtype == torch.float32
    np.testing.assert_allclose(b11.numpy(), np.asarray(a11), atol=1e-5)
    np.testing.assert_allclose(rhs[..., :UP].transpose(1, 2).numpy(),
                               np.asarray(a21), atol=1e-5)
    np.testing.assert_array_equal(rhs[..., UP].numpy(), z1)


@pytest.mark.parametrize("weighted", [True, False])
def test_region_tail_matches(panel, weighted):
    G, Gp, sizes, padded = panel
    js, ts, j_in, t_in, host = _region_inputs(G, Gp, sizes, padded,
                                              weighted, seed=13)
    Z1, m_mask, u_mask = host
    ref = np.asarray(jwk.build_resident_region_kernel(js, MP, UP)(
        *j_in, *(jnp.asarray(x) for x in host)))
    fn = twk.build_resident_region_kernel(ts, MP, UP)
    got = fn(*t_in, *(torch.from_numpy(x) for x in host)).numpy()
    assert got.shape == (2, W, UP)
    real = u_mask > 0
    np.testing.assert_allclose(got[0][real], ref[0][real], rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got[1][real], ref[1][real], rtol=2e-4,
                               atol=2e-5)
    # compaction form: the real rows in (window, column) order
    wi, ci = np.nonzero(real)
    comp = fn(*t_in, *(torch.from_numpy(x) for x in host),
              torch.from_numpy(wi), torch.from_numpy(ci)).numpy()
    np.testing.assert_array_equal(comp, got[:, wi, ci])


def test_slabs_split_equally_and_match_one_batch(panel, monkeypatch):
    assert twk.win_slab(43) == 43
    assert twk.win_slab(64) == 64
    assert twk.win_slab(65) == 33
    assert twk.win_slab(130) == 44
    G, Gp, sizes, padded = panel
    _, ts, _, t_in, host = _region_inputs(G, Gp, sizes, padded, True)
    host = [torch.from_numpy(x) for x in host]
    whole = twk.build_resident_region_kernel(ts, MP, UP)(*t_in, *host)
    monkeypatch.setattr(twk, "WIN_SLAB", 1)
    split = twk.build_resident_region_kernel(ts, MP, UP)(*t_in, *host)
    # same arithmetic, but LAPACK/BLAS block the batch differently: f32
    # rounding noise only
    np.testing.assert_allclose(split.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_failed_cholesky_gives_nan_window():
    rng = np.random.default_rng(14)
    B11 = torch.eye(8).repeat(2, 1, 1)
    B11[1, 3, 3] = -1.0                  # window 1 is not positive definite
    B21 = torch.from_numpy(rng.standard_normal((2, 4, 8)).astype(
        np.float32)) * 0.1
    z1 = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    rhs = torch.cat([B21.transpose(1, 2), z1[:, :, None]], dim=2)
    z, info = twk._impute_tail(B11, rhs)
    assert torch.isfinite(z[0]).all() and torch.isfinite(info[0]).all()
    assert torch.isnan(z[1]).all() and torch.isnan(info[1]).all()


# -- the region tail's kernels (ops/region_tail) ------------------------------

def _tail_case(weighted, W=3, Mp=128, Up=64, seed=15, pops=3, past_r=False,
               device="cpu"):
    """One slab of the tail's inputs on ``device``, from a random panel of
    ``pops`` populations with LD between neighbouring SNPs: the resident
    statistics (prepare_resident_panel), the band offsets, masks with
    padding rows in every window, K1's Grams (T1_mm's strict upper triangle
    overwritten with garbage, as sym mode leaves it), Z1, alpha and w.
    ``past_r``: the resident arrays end at the last window's last real row,
    so its bands run past them (masked rows that read as zero)."""
    rng = np.random.default_rng(seed)
    if pops == 3:
        sizes, wgts = (40, 50, 38), (0.5, 0.3, 0.2)
    else:
        sizes = tuple(int(m) for m in rng.integers(6, 14, pops))
        wgts = tuple(float(x) for x in rng.dirichlet(np.ones(pops)))
    R = max(260, 20 * (W - 1) + Mp)
    freq = rng.uniform(0.05, 0.6, (len(sizes),))
    cols = []
    for f, m in zip(freq, sizes):
        x = rng.binomial(2, f, (1, m))
        rows = [x]
        for _ in range(R - 1):       # each SNP a noisy copy of the last
            keep = rng.random((1, m)) < 0.7
            x = np.where(keep, x, rng.binomial(2, f, (1, m)))
            rows.append(x)
        cols.append(np.concatenate(rows))
    G = np.concatenate(cols, axis=1).astype(np.int8)
    Gp, padded = twk.pad_pop_segments(G, sizes, multiple=pg.K_TILE)
    spec = twk.WindowKernelSpec(pop_sizes=sizes, pop_sizes_padded=padded,
                                wgts=wgts if weighted else None)
    Ms = [(Mp - 17, Mp - 40, 9)[w % 3] for w in range(W)]
    Us = [(Up - 5, 30, Up)[w % 3] for w in range(W)]
    rows_m = np.full(W * Mp, -1, np.int32)
    rows_u = np.full(W * Up, -1, np.int32)
    m_mask = np.zeros((W, Mp), np.float32)
    u_mask = np.zeros((W, Up), np.float32)
    for w in range(W):
        rows_m[w * Mp:w * Mp + Ms[w]] = np.arange(Ms[w]) + 20 * w
        rows_u[w * Up:w * Up + Us[w]] = rng.choice(R, Us[w], replace=False)
        m_mask[w, :Ms[w]] = 1
        u_mask[w, :Us[w]] = 1
    if past_r:
        rows_m = rows_m[:(W - 1) * Mp + Ms[-1]]
        rows_u = rows_u[:(W - 1) * Up + Us[-1]]
    dev = torch.device(device)
    Gt = torch.from_numpy(Gp).to(dev)
    Xm, Spm, Mum, _ = twk.prepare_resident_panel(
        Gt, torch.from_numpy(rows_m).to(dev), None, spec)
    Xu, Spu, Muu, Vu = twk.prepare_resident_panel(
        Gt, torch.from_numpy(rows_u).to(dev), None, spec)
    m_t0 = (torch.arange(W, dtype=torch.int32) * Mp).to(dev)
    u_t0 = (torch.arange(W, dtype=torch.int32) * Up).to(dev)
    segs = twk._gram_segments(spec)
    t1_mm = gram.weighted_gram_t1(Xm, Xm, *segs, m_t0, m_t0, Mp, Mp,
                                  sym=True)
    t1_mm += torch.triu(torch.from_numpy(rng.standard_normal(
        (W, Mp, Mp)).astype(np.float32)) * 1e3, 1).to(dev)
    t1_um = gram.weighted_gram_t1(Xu, Xm, *segs, u_t0, m_t0, Up, Mp)
    z1 = (rng.standard_normal((W, Mp)) * 1.5 * m_mask).astype(np.float32)
    alpha, w = twk._ResidentBlocks(spec, Mp, Up).weights(dev)
    return dict(t1_mm=t1_mm, t1_um=t1_um, Spm=Spm, Mum=Mum, Spu=Spu,
                Muu=Muu, Vu=Vu, m_t0=m_t0, u_t0=u_t0,
                m_mask=torch.from_numpy(m_mask).to(dev),
                u_mask=torch.from_numpy(u_mask).to(dev),
                z1=torch.from_numpy(z1).to(dev), alpha=alpha, w=w, diag=1.1)


def _padded(c):
    """The case with its statistics padded by zero rows to cover every
    band: what the kernels read past the arrays' end, for the plain
    versions and the formulas, which index the rows."""
    Mp, Up = c["t1_mm"].shape[1], c["t1_um"].shape[1]
    n_m = int(c["m_t0"].max()) + Mp
    n_u = int(c["u_t0"].max()) + Up

    def pad(A, n):
        return torch.cat([A, A.new_zeros((max(0, n - A.shape[0]),)
                                         + A.shape[1:])])

    return dict(c, Spm=pad(c["Spm"], n_m), Mum=pad(c["Mum"], n_m),
                Spu=pad(c["Spu"], n_u), Muu=pad(c["Muu"], n_u),
                Vu=pad(c["Vu"], n_u))


def _tail_calls(c):
    """B11, std_m, mi_m and the right-hand side through the wrappers."""
    B11, std_m, mi_m = region_tail.corr_mm(
        c["t1_mm"], c["Spm"], c["Mum"], c["m_t0"], c["m_mask"], c["alpha"],
        c["w"], c["diag"])
    rhs = region_tail.corr_um_rhs(
        c["t1_um"], c["Spu"], c["Muu"], c["Vu"], c["u_t0"], c["Spm"],
        c["Mum"], c["m_t0"], std_m, mi_m, c["u_mask"], c["m_mask"], c["z1"],
        c["alpha"], c["w"])
    return B11, std_m, mi_m, rhs


def _tail_formulas(c):
    """CalWgtCov's blocks in float64 numpy from the same f32 inputs:
    cov = T1 - sum_k alpha_k s_k s_k' + sum_k w_k mu_k mu_k' - mi mi', std
    from the diagonal (measured) or V + sum_k w_k mu_k^2 - mi^2
    (unmeasured), 1 on masked rows; (B11, [B21^T | Z1])."""
    f = lambda t: t.double().numpy()
    Mp, Up = c["t1_mm"].shape[1], c["t1_um"].shape[1]
    band = lambda A, t0, n: f(A)[f(t0).astype(int)[:, None] + np.arange(n)]
    sm, su = band(c["Spm"], c["m_t0"], Mp), band(c["Spu"], c["u_t0"], Up)
    a = f(c["alpha"])
    T = np.tril(f(c["t1_mm"]))
    T = T + np.tril(T, -1).transpose(0, 2, 1)
    cmm = T - np.einsum("wip,p,wjp->wij", sm, a, sm)
    cum = f(c["t1_um"]) - np.einsum("wip,p,wjp->wij", su, a, sm)
    var_u = band(c["Vu"], c["u_t0"], Up)
    if c["w"] is not None:
        w = f(c["w"])
        mm, mu = band(c["Mum"], c["m_t0"], Mp), band(c["Muu"], c["u_t0"], Up)
        mim, miu = mm @ w, mu @ w
        cmm += np.einsum("wip,p,wjp->wij", mm, w, mm) - mim[:, :, None] \
            * mim[:, None, :]
        cum += np.einsum("wip,p,wjp->wij", mu, w, mm) - miu[:, :, None] \
            * mim[:, None, :]
        var_u = var_u + (mu * mu) @ w - miu * miu
    mk_m, mk_u = f(c["m_mask"]), f(c["u_mask"])
    sd_m = np.sqrt(np.where(mk_m > 0, np.einsum("wii->wi", cmm), 1.0))
    sd_u = np.sqrt(np.where(mk_u > 0, var_u, 1.0))
    B11 = cmm / (sd_m[:, :, None] * sd_m[:, None, :]) \
        * (mk_m[:, :, None] * mk_m[:, None, :])
    B11[:, np.arange(Mp), np.arange(Mp)] = c["diag"]
    B21 = cum / (sd_u[:, :, None] * sd_m[:, None, :]) \
        * (mk_u[:, :, None] * mk_m[:, None, :])
    return B11, np.concatenate([B21.transpose(0, 2, 1),
                                f(c["z1"])[:, :, None]], axis=2)


# (W, Mp, Up, populations, bands past the statistics' end): the card's
# cases, from more tiles than resident blocks (16 x 78 corr_mm and 16 x 96
# corr_um_rhs tiles, the last window's bands running past R) to one tile
TAIL_SHAPES = {
    "W3-Mp128-Up64-P3": (3, 128, 64, 3, False),
    "W16-Mp768-Up512-P29-past-R": (16, 768, 512, 29, True),
    "W1-Mp64-Up64-P29": (1, 64, 64, 29, False),
    "W1-Mp1280-Up960-P29": (1, 1280, 960, 29, False),
}


@pytest.mark.parametrize("shape", ["W3-Mp128-Up64-P3", "W1-Mp64-Up64-P29"])
@pytest.mark.parametrize("weighted", [True, False])
def test_region_tail_plain_versions_match_formulas(weighted, shape):
    """ops/region_tail's plain versions (CPU tensors take them) against the
    formulas in float64, masked rows included; B11 and the right-hand side
    to 1e-5 (f32 arithmetic on correlations of a few hundred subjects),
    masked rows and columns exactly zero, Z1 the last column."""
    W, Mp, Up, pops, _ = TAIL_SHAPES[shape]
    c = _tail_case(weighted, W, Mp, Up, pops=pops)
    B11, std_m, mi_m, rhs = _tail_calls(c)
    ref11, ref_rhs = _tail_formulas(c)
    assert B11.shape == (W, Mp, Mp) and rhs.shape == (W, Mp, Up + 1)
    assert std_m.shape == (W, Mp) and (mi_m is None) == (not weighted)
    np.testing.assert_allclose(B11.numpy(), ref11, atol=1e-5)
    np.testing.assert_allclose(rhs.numpy(), ref_rhs, atol=1e-5)
    pad_m, pad_u = c["m_mask"] == 0, c["u_mask"] == 0
    off = B11 - torch.diag_embed(torch.diagonal(B11, dim1=1, dim2=2))
    assert (off.transpose(1, 2)[pad_m] == 0).all() and (off[pad_m] == 0).all()
    assert (rhs[..., :Up].transpose(1, 2)[pad_u] == 0).all()
    assert (rhs[..., :Up][pad_m] == 0).all()
    assert (torch.diagonal(B11, dim1=1, dim2=2) == c["diag"]).all()
    assert torch.equal(rhs[..., Up], c["z1"])


def _solved(c, B11, rhs):
    L, bad = torch.linalg.cholesky_ex(B11)
    return torch.linalg.solve_triangular(L, rhs, upper=False), bad


def test_impute_finalize_plain_matches_formulas():
    """z and info from the solve's column-major output against the
    formulas in float64, a failed factorization NaN in its window alone;
    an output that is not column-major in each window raises."""
    rng = np.random.default_rng(16)
    Y = rng.standard_normal((3, 40, 9)).astype(np.float32)
    bad = torch.tensor([0, 3, 0], dtype=torch.int32)
    col_major = torch.from_numpy(Y.transpose(0, 2, 1).copy()).transpose(1, 2)
    assert col_major.stride(1) == 1
    got = region_tail.impute_finalize(col_major, bad).numpy()
    Yd = Y.astype(np.float64)
    info = (Yd[:, :, :8] ** 2).sum(axis=1)
    z = np.einsum("wmu,wm->wu", Yd[:, :, :8], Yd[:, :, 8]) / np.sqrt(info)
    assert got.shape == (2, 3, 8)
    for k in (0, 2):
        np.testing.assert_allclose(got[0, k], z[k], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[1, k], info[k], rtol=1e-5)
    assert np.isnan(got[:, 1]).all()
    with pytest.raises(ValueError, match="column-major"):
        region_tail.impute_finalize(torch.from_numpy(Y), bad)


@pytest.mark.parametrize("weighted", [True, False])
def test_region_tail_failed_window_is_nan(weighted):
    """A window whose B11 is not positive definite gets NaN z and info
    from the tail, the others stay finite."""
    c = _tail_case(weighted)
    B11, _, _, rhs = _tail_calls(c)
    B11[1, 3, 3] = -1.0
    out = twk._impute_tail(B11, rhs)
    assert out.shape == (2, 3, 64)
    assert torch.isnan(out[:, 1]).all()
    real = c["u_mask"] > 0
    assert torch.isfinite(out[:, 0][:, real[0]]).all()
    assert torch.isfinite(out[:, 2][:, real[2]]).all()


def test_cuda_tensors_never_fall_back(monkeypatch):
    """A CUDA tensor goes to the kernel library or raises; it never takes
    the plain version (fake CUDA tensors: the library is replaced by one
    that refuses).  Tensors on another non-CPU device raise too."""
    fake_mode = pytest.importorskip("torch._subclasses.fake_tensor")
    c = _tail_case(True, W=1)
    Yall = torch.zeros((1, 65, 128)).transpose(1, 2)
    bad = torch.zeros(1, dtype=torch.int32)

    def refuse():
        raise RuntimeError("no kernel library here")

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(_build, "library", refuse)
    for name in ("corr_mm_plain", "corr_um_rhs_plain",
                 "impute_finalize_plain", "cholesky_solve_plain"):
        monkeypatch.setattr(region_tail, name, plain)
    try:
        mode = fake_mode.FakeTensorMode()
        with mode:
            torch.empty(1, device="cuda")
    except Exception as e:           # no fake CUDA device in this build
        pytest.skip(f"cannot make a fake CUDA tensor here: {e}")

    def calls(c, Yall, bad):
        yield lambda: _tail_calls(c)
        yield lambda: region_tail.corr_um_rhs(
            c["t1_um"], c["Spu"], c["Muu"], c["Vu"], c["u_t0"], c["Spm"],
            c["Mum"], c["m_t0"], c["m_mask"], c["m_mask"], c["u_mask"],
            c["m_mask"], c["z1"], c["alpha"], c["w"])
        yield lambda: region_tail.impute_finalize(Yall, bad)
        yield lambda: region_tail.cholesky_solve(c["t1_mm"], Yall)
        yield lambda: region_tail.cholesky_solve(c["t1_mm"], Yall, True)

    def on(d):
        new = lambda v: torch.empty_strided(v.shape, v.stride(),
                                            dtype=v.dtype, device=d)
        return ({k: new(v) if isinstance(v, torch.Tensor) else v
                 for k, v in c.items()}, new(Yall), new(bad))

    with mode:
        for call in calls(*on("cuda")):
            with pytest.raises(RuntimeError, match="no kernel library"):
                call()
    for call in calls(*on("meta")):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def _gpu_case(weighted, shape="W3-Mp128-Up64-P3"):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    W, Mp, Up, pops, past_r = TAIL_SHAPES[shape]
    return _tail_case(weighted, W, Mp, Up, pops=pops, past_r=past_r,
                      device="cuda")


def _plain_calls(c):
    """_tail_calls through the plain versions, on the zero-padded
    statistics (they index the rows)."""
    saved = {n: getattr(region_tail, n) for n in ("corr_mm", "corr_um_rhs")}
    try:
        region_tail.corr_mm = region_tail.corr_mm_plain
        region_tail.corr_um_rhs = region_tail.corr_um_rhs_plain
        return _tail_calls(_padded(c))
    finally:
        for n, f in saved.items():
            setattr(region_tail, n, f)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(TAIL_SHAPES))
@pytest.mark.parametrize("weighted", [True, False])
def test_region_tail_kernels_match_plain_on_gpu(weighted, shape):
    """Each kernel against its plain version on the card, weighted and
    pooled, at every TAIL_SHAPES case (more tiles than resident blocks,
    bands past the statistics' end, one tile, one window): B11 and the
    right-hand side to 1e-5, B11 exactly symmetric, std to rtol 1e-5, z
    and info within the region bar; each launched once per call."""
    c = _gpu_case(weighted, shape)
    with full_f32_matmul():
        for k in region_tail.launches:
            region_tail.launches[k] = 0
        B11, std_m, mi_m, rhs = _tail_calls(c)
        # the tail solves in place: it gets copies, the blocks stay
        zi = twk._impute_tail(B11.clone(), rhs.clone())
        launched = dict(region_tail.launches)
        p11, pstd, pmi, prhs = _plain_calls(c)
        L, bad = torch.linalg.cholesky_ex(p11)
        pz = region_tail.impute_finalize_plain(
            torch.linalg.solve_triangular(L, prhs, upper=False), bad)
    torch.cuda.synchronize()
    assert launched == {"corr_mm": 1, "corr_um_rhs": 1, "impute_finalize": 1,
                        "cholesky_solve": 1}
    assert torch.equal(B11, B11.transpose(1, 2))
    np.testing.assert_allclose(B11.cpu().numpy(), p11.cpu().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(rhs.cpu().numpy(), prhs.cpu().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(std_m.cpu().numpy(), pstd.cpu().numpy(),
                               rtol=1e-5)
    if weighted:
        np.testing.assert_allclose(mi_m.cpu().numpy(), pmi.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
    real = c["u_mask"].cpu().numpy() > 0
    zi, pz = zi.cpu().numpy(), pz.cpu().numpy()
    np.testing.assert_allclose(zi[0][real], pz[0][real], rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(zi[1][real], pz[1][real], rtol=2e-4,
                               atol=2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [True, False])
def test_region_tail_failed_window_is_nan_on_gpu(weighted):
    """On the card, at more tiles than resident blocks: a window whose B11
    is not positive definite gets NaN z and info, the others stay finite
    on their real columns."""
    c = _gpu_case(weighted, "W16-Mp768-Up512-P29-past-R")
    with full_f32_matmul():
        B11, _, _, rhs = _tail_calls(c)
        B11[5, 3, 3] = -1.0
        out = twk._impute_tail(B11, rhs).cpu()
    real = (c["u_mask"] > 0).cpu()
    assert torch.isnan(out[:, 5]).all()
    for w in range(16):
        if w != 5:
            assert torch.isfinite(out[:, w][:, real[w]]).all(), w


@pytest.mark.gpu
def test_region_tail_kernels_follow_the_tf32_switch_on_gpu():
    """With allow_tf32 on and no full_f32_matmul around them, the kernels
    round their products' operands to TF32 as the torch matmuls they
    replaced do: B11, the right-hand side and z move from the f32 result
    by a TF32-sized amount (well above the f32 noise between kernel and
    plain version, well below the values)."""
    c = _gpu_case(True)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        f32 = _tail_calls(c)
        z32 = twk._impute_tail(f32[0].clone(), f32[3].clone())
        plain = _plain_calls(c)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf = _tail_calls(c)
        ztf = twk._impute_tail(tf[0].clone(), tf[3].clone())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    real = c["u_mask"] > 0
    for k, what in ((0, "B11"), (3, "rhs")):
        noise = float((f32[k] - plain[k]).abs().max())
        moved = float((tf[k] - f32[k]).abs().max())
        assert max(1e-6, 10 * noise) < moved < 1e-2, (what, noise, moved)
    dz = float((ztf[0] - z32[0])[real].abs().max())
    assert 1e-6 < dz < 0.5, dz

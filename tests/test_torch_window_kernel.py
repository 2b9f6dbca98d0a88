"""Resident region kernel (gauss_tpu_torch.ops.window_kernel) against
gauss_tpu.ops.window_kernel on the same inputs, the JAX side's Pallas
Gram in interpret mode.

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
    G, Gp, sizes, padded = panel
    js, ts, j_in, t_in, (_, m_mask, u_mask) = _region_inputs(
        G, Gp, sizes, padded, weighted)
    a11, a21 = jwk._resident_block_builder(js, MP, UP)(
        *j_in, jnp.asarray(m_mask), jnp.asarray(u_mask))
    b11, b21 = twk._ResidentBlocks(ts, MP, UP)(
        *t_in, torch.from_numpy(m_mask), torch.from_numpy(u_mask))
    assert b11.shape == (W, MP, MP) and b21.shape == (W, UP, MP)
    assert b11.dtype == b21.dtype == torch.float32
    np.testing.assert_allclose(b11.numpy(), np.asarray(a11), atol=1e-5)
    np.testing.assert_allclose(b21.numpy(), np.asarray(a21), atol=1e-5)


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
    z, info = twk._impute_tail(B11, B21, z1)
    assert torch.isfinite(z[0]).all() and torch.isfinite(info[0]).all()
    assert torch.isnan(z[1]).all() and torch.isnan(info[1]).all()

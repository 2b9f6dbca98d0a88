"""K1 (gauss_tpu_torch.ops.gram): the plain version against the Pallas
TPU kernel gauss_tpu.ops.pallas_gram.weighted_gram_t1 in interpret mode,
and the CUDA kernel against the plain version on a card.

Tolerance: rel < 1e-6 of the largest entry -- both sides sum exact
integer cross products and differ only in the f32 rounding of the
per-segment folds."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.ops import pallas_gram as pg
from gauss_tpu_torch.ops import gram

REL = 1e-6


def _shifted(rng, n_rows, sizes, padded):
    """Shifted dosages in [-2, 2], zero on segment padding."""
    X = np.zeros((n_rows, sum(padded)), np.int8)
    lo = 0
    for m, p in zip(sizes, padded):
        X[:, lo:lo + m] = rng.integers(-2, 3, (n_rows, m))
        lo += p
    return X


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _jax_batched(X, Y, sizes, padded, wgts, x_rows, y_rows, nx, ny, sym):
    R = pg.ROW_TILE
    return np.asarray(pg.weighted_gram_t1(
        jnp.asarray(X), jnp.asarray(Y), sizes, padded, wgts,
        n_sym=nx // R if sym else 0, interpret=True, nx=nx, ny=ny,
        x_tile0=jnp.asarray(np.asarray(x_rows) // R, jnp.int32),
        y_tile0=jnp.asarray(np.asarray(y_rows) // R, jnp.int32)))


def _case(seed=3):
    rng = np.random.default_rng(seed)
    sizes = (100, 300, 55, 220)
    padded = tuple(-(-m // pg.K_TILE) * pg.K_TILE for m in sizes)
    wgts = tuple(rng.dirichlet(np.ones(len(sizes))).tolist())
    R = pg.ROW_TILE
    X = _shifted(rng, 3 * R, sizes, padded)
    Y = _shifted(rng, 2 * R, sizes, padded)
    return sizes, padded, wgts, X, Y


@pytest.mark.parametrize("mode", ["mm_sym", "um"])
def test_plain_matches_pallas_batched_offsets(mode):
    sizes, padded, wgts, X, Y = _case()
    R = pg.ROW_TILE
    if mode == "mm_sym":
        A, B, xr, yr, sym = X, X, [2 * R, 0], [2 * R, 0], True
    else:
        A, B, xr, yr, sym = Y, X, [R, 0], [2 * R, R], False
    ref = _jax_batched(A, B, sizes, padded, wgts, xr, yr, R, R, sym)
    got = gram.weighted_gram_t1(
        torch.from_numpy(A), torch.from_numpy(B), sizes, padded, wgts,
        torch.tensor(xr, dtype=torch.int32),
        torch.tensor(yr, dtype=torch.int32), R, R, sym=sym)
    assert got.dtype == torch.float32 and got.shape == (2, R, R)
    if sym:
        ref = np.asarray(pg.mirror_lower(jnp.asarray(ref)))
        got = gram.mirror_lower(got)
    assert _rel(got.numpy(), ref) < REL


def test_plain_matches_pallas_pooled():
    """Pooled mode: one segment over the padded axis, beta == 1.0f."""
    sizes, padded, _, X, _ = _case(seed=4)
    n = sum(sizes)
    seg = ((n,), (sum(padded),), ((n - 1.0) / (float(n) * n),))
    assert gram.fold_factors(seg[0], seg[2])[0] == np.float32(1.0)
    R = pg.ROW_TILE
    ref = _jax_batched(X, X, *seg, [0, R], [0, R], R, R, True)
    got = gram.weighted_gram_t1(torch.from_numpy(X), torch.from_numpy(X),
                                *seg, torch.tensor([0, R], dtype=torch.int32),
                                torch.tensor([0, R], dtype=torch.int32), R, R,
                                sym=True)
    ref = np.asarray(pg.mirror_lower(jnp.asarray(ref)))
    np.testing.assert_array_equal(gram.mirror_lower(got).numpy(), ref)


def test_plain_matches_float64_oracle_at_port_padding():
    """At the port's own 64-column padding (which the TPU kernel does not
    take), the plain version equals sum_k beta_k X_k Y_k^T in float64."""
    rng = np.random.default_rng(5)
    sizes = (70, 130, 9)
    padded = tuple(-(-m // gram.K_CHUNK) * gram.K_CHUNK for m in sizes)
    wgts = (0.2, 0.5, 0.3)
    X = _shifted(rng, 192, sizes, padded)
    x0 = torch.tensor([0, 64, 128], dtype=torch.int32)
    got = gram.weighted_gram_t1(torch.from_numpy(X), torch.from_numpy(X),
                                sizes, padded, wgts, x0, x0, 64, 64)
    beta = gram.fold_factors(sizes, wgts).astype(np.float64)
    bounds = np.concatenate([[0], np.cumsum(padded)])
    for w in range(3):
        band = X[64 * w:64 * w + 64].astype(np.float64)
        ref = sum(beta[k] * band[:, bounds[k]:bounds[k + 1]]
                  @ band[:, bounds[k]:bounds[k + 1]].T for k in range(3))
        assert _rel(got[w].numpy(), ref) < REL


def test_mirror_lower_matches_jax():
    A = np.random.default_rng(6).standard_normal((3, 8, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        gram.mirror_lower(torch.from_numpy(A)).numpy(),
        np.asarray(pg.mirror_lower(jnp.asarray(A))))


def test_rows_past_the_end_read_as_zero():
    rng = np.random.default_rng(7)
    X = torch.from_numpy(_shifted(rng, 100, (64,), (64,)))
    x0 = torch.tensor([64], dtype=torch.int32)
    got = gram.weighted_gram_t1(X, X, (64,), (64,), (1.0,), x0, x0, 64, 64)
    assert torch.all(got[0, 36:] == 0) and torch.all(got[0, :, 36:] == 0)
    assert torch.any(got[0, :36, :36] != 0)


def test_wrapper_checks_and_cpu_path_does_not_count():
    X = torch.zeros((64, 64), dtype=torch.int8)
    x0 = torch.zeros(1, dtype=torch.int32)
    before = gram.launches
    gram.weighted_gram_t1(X, X, (10,), (64,), (1.0,), x0, x0, 64, 64)
    assert gram.launches == before
    with pytest.raises(TypeError):
        gram.weighted_gram_t1(X.to(torch.int16), X, (10,), (64,), (1.0,),
                              x0, x0, 64, 64)
    with pytest.raises(TypeError):
        gram.weighted_gram_t1(X, X, (10,), (64,), (1.0,), x0.long(),
                              x0.long(), 64, 64)
    with pytest.raises(ValueError):
        gram.weighted_gram_t1(X, X, (10,), (64,), (1.0,), x0, x0, 32, 64)
    with pytest.raises(ValueError):
        gram.weighted_gram_t1(X, X, (10,), (128,), (1.0,), x0, x0, 64, 64)


def _pad64(sizes):
    return tuple(-(-m // gram.K_CHUNK) * gram.K_CHUNK for m in sizes)


def _kernel_case(name):
    """Inputs of one edge case of the CUDA kernel's tiling (128 x 128
    output tiles, 128-column K boxes of two 64-column chunks):
    (A, B, sizes, padded, wgts, a0, b0, nx, ny, sym), numpy."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    sizes, wgts = (1538, 6360, 85, 164), (0.1, 0.4, 0.2, 0.3)
    if name == "segment_ends_inside_box":
        # ends after chunks 1, 4 and 9: mid-box, end of box, mid-box of
        # an odd last box
        sizes, wgts = (50, 130, 300), (0.5, 0.2, 0.3)
    elif name == "segments_29":
        sizes = tuple(int(m) for m in rng.integers(20, 400, 29))
        wgts = tuple(rng.dirichlet(np.ones(29)).tolist())
    elif name == "pooled":
        n = 2000
        sizes, wgts = (n,), ((n - 1.0) / (float(n) * n),)
    padded = _pad64(sizes)
    nx = ny = 256
    sym = False
    rows_a = rows_b = 3 * 256
    a0 = b0 = [0, 256, 512]
    same = False
    if name == "mm_sym":
        same, sym = True, True
    elif name == "um":
        rows_a, a0, nx = 3 * 192, [0, 192, 400], 192
    elif name == "partial_tile_rows":        # nx = 64 mod 128
        rows_a, a0, nx = 3 * 192, [0, 192, 384], 192
    elif name == "partial_tile_cols":        # ny = 64 mod 128
        rows_b, b0, ny = 3 * 192, [0, 192, 384], 192
    elif name == "unaligned_offsets_sym":
        same, sym, rows_a, a0, nx, ny = True, True, 1000, [37, 301, 555], \
            320, 320
    elif name == "unaligned_offsets_um":
        rows_a, a0, nx = 900, [5, 133, 611], 192
        rows_b, b0, ny = 1000, [37, 301, 555], 320
    elif name == "rows_past_end":
        rows_a, a0, nx = 300, [100, 250], 128
        rows_b, b0, ny = 400, [0, 300], 192
    elif name == "rows_past_end_sym":
        same, sym, rows_a, a0 = True, True, 300, [0, 200, 290]
    elif name in ("segment_ends_inside_box", "segments_29"):
        nx, ny, a0, b0 = 128, 192, [0, 300], [64, 500]
    elif name == "pooled":
        same, sym = True, True
    elif name == "w1":
        same, sym, a0 = True, True, [40]
    elif name == "w64":
        rows_a, rows_b = 64 * 64, 64 * 128 + 64
        a0 = [64 * w for w in range(64)]
        b0 = [128 * w + 17 for w in range(64)]
        nx, ny = 64, 128
    else:
        raise ValueError(name)
    if same:
        rows_b, b0, ny = rows_a, a0, nx
    A = _shifted(rng, rows_a, sizes, padded)
    B = A if same else _shifted(rng, rows_b, sizes, padded)
    return A, B, sizes, padded, wgts, a0, b0, nx, ny, sym


KERNEL_CASES = ["mm_sym", "um", "partial_tile_rows", "partial_tile_cols",
                "unaligned_offsets_sym", "unaligned_offsets_um",
                "rows_past_end", "rows_past_end_sym",
                "segment_ends_inside_box", "segments_29", "pooled", "w1",
                "w64"]


def _band_np(A, offs, n):
    band = np.zeros((len(offs), n, A.shape[1]), A.dtype)
    for w, o in enumerate(offs):
        rows = A[o:o + n]
        band[w, :len(rows)] = rows
    return band


@pytest.mark.parametrize("case", KERNEL_CASES)
def test_plain_matches_reference_on_kernel_cases(case):
    """The plain version on each kernel edge case against gauss_tpu's
    float64 oracle (which returns T1 less sum_k alpha_k s_x s_y^T,
    alpha_k = w_k m_k / (m_k - 1); added back here)."""
    A, B, sizes, padded, wgts, a0, b0, nx, ny, sym = _kernel_case(case)
    got = gram.weighted_gram_t1(
        torch.from_numpy(A), torch.from_numpy(B), sizes, padded, wgts,
        torch.tensor(a0, dtype=torch.int32),
        torch.tensor(b0, dtype=torch.int32), nx, ny, sym=sym)
    assert got.shape == (len(a0), nx, ny)
    m, wv = np.asarray(sizes, np.float64), np.asarray(wgts, np.float64)
    alpha = wv * m / (m - 1.0)
    bounds = np.concatenate([[0], np.cumsum(padded)])
    Xb, Yb = _band_np(A, a0, nx), _band_np(B, b0, ny)
    for w in range(len(a0)):
        x, y = Xb[w].astype(np.float64), Yb[w].astype(np.float64)
        ref = pg.weighted_gram_reference(x, y, sizes, padded, wgts)
        for k in range(len(sizes)):
            lo, hi = bounds[k], bounds[k + 1]
            ref += alpha[k] * np.outer(x[:, lo:hi].sum(1), y[:, lo:hi].sum(1))
        assert _rel(got[w].numpy(), ref) < REL


@pytest.mark.gpu
@pytest.mark.parametrize("case", KERNEL_CASES + ["sym_lower_equals_full"])
def test_kernel_matches_plain_on_gpu(case):
    """One launch per case, rel <= 1e-6 against the plain version (sym
    outputs mirrored on both sides); the sym launch's lower triangle
    equals a full launch's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    full = case == "sym_lower_equals_full"
    A, B, sizes, padded, wgts, a0, b0, nx, ny, sym = _kernel_case(
        "unaligned_offsets_sym" if full else case)
    same = B is A
    A = torch.from_numpy(A).to(dev)
    B = A if same else torch.from_numpy(B).to(dev)
    a0 = torch.tensor(a0, dtype=torch.int32, device=dev)
    b0 = torch.tensor(b0, dtype=torch.int32, device=dev)
    before = gram.launches
    got = gram.weighted_gram_t1(A, B, sizes, padded, wgts, a0, b0, nx, ny,
                                sym=sym)
    torch.cuda.synchronize()
    assert gram.launches == before + 1
    ref = gram.weighted_gram_t1_plain(A, B, sizes, padded, wgts, a0, b0,
                                      nx, ny)
    if sym:
        assert torch.isfinite(torch.tril(got)).all()
        got, ref = gram.mirror_lower(got), gram.mirror_lower(ref)
    assert _rel(got.cpu().numpy(), ref.cpu().numpy()) < REL
    if full:
        whole = gram.weighted_gram_t1(A, B, sizes, padded, wgts, a0, b0, nx,
                                      ny, sym=False)
        torch.cuda.synchronize()
        assert gram.launches == before + 2
        assert torch.equal(torch.tril(whole), torch.tril(got))

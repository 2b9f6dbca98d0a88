"""The region tail's Cholesky factorization and forward solve
(gauss_tpu_torch.ops.region_tail.cholesky_solve, csrc/chol_solve.cu).

On the CPU its plain version (the library pair cholesky_ex +
solve_triangular) against gauss_tpu's blocked Cholesky and triangular
solve (ops/window_kernel._blocked_cholesky_lower / _blocked_trsm_lower) on
the same seeded blocks, info as cholesky_ex gives it, the wrapper's
refusals on fake CUDA tensors, and the kernel's arithmetic emulated in
plain torch (its blocked left-looking algorithm on 64-wide blocks, its
3xTF32 tile products with cvt.rna rounding, its compensation per 64 k)
against a float64 solve; on the card (``gpu``) the kernel against its
plain version, a slab with failed windows, and its results bit-equal
between runs and between slabs of other widths.

The blocks are what the region tails solve: B11 the correlations of Mp
"measured" SNPs with the ridge (diagonal 1 + LAMBDA), the right-hand side
[B21^T | Z1] their correlations with Up others and a z column, from a
panel of AR(1) rows (neighbours correlated, as LD is).  B11's strict upper
triangle holds garbage wherever only its lower triangle should be read.

Tolerances, normwise (max|d| / max|ref|): 2e-5 against gauss_tpu (two f32
algorithms, LAPACK's blocked potrf / trsm and gauss_tpu's explicit inverses
of the diagonal blocks, on blocks of condition number ~1e2: each within a
few 1e-6 of the float64 solution); on the card 1e-5 between kernel and
library pair (both backward stable in f32, blocked differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SOLVE_ACC, solve_bounds
from gauss_tpu.ops import window_kernel as jwk
from gauss_tpu_torch.core.stats import full_f32_matmul
from gauss_tpu_torch.ops import _build, region_tail
from gauss_tpu_torch.ops import window_kernel as twk

LAMBDA = 0.1
JAX_TOL = 2e-5
GPU_TOL = 1e-5


def blocks(W, Mp, Up, seed=31, rho=0.8, device="cpu"):
    """(B11 [W, Mp, Mp] exactly symmetric, rhs [W, Mp, Up + 1] row-major)
    float32 on ``device``: correlations over n = Mp / 2 subjects of a
    panel of Mp + Up AR(1) rows, Mp of them (every other one, then the
    rest) measured."""
    rng = np.random.default_rng(seed)
    n, R = max(Mp // 2, 16), Mp + Up
    eps = rng.standard_normal((W, R, n)).astype(np.float32)
    X = np.empty_like(eps)
    X[:, 0] = eps[:, 0]
    for r in range(1, R):
        X[:, r] = rho * X[:, r - 1] + np.sqrt(1 - rho * rho) * eps[:, r]
    X = torch.from_numpy(X).to(device)
    X = X - X.mean(dim=2, keepdim=True)
    X = X / X.norm(dim=2, keepdim=True)
    m = torch.cat([torch.arange(0, 2 * min(Mp, R - Mp), 2),
                   torch.arange(2 * min(Mp, R - Mp), R)])[:Mp]
    u = torch.tensor(sorted(set(range(R)) - set(m.tolist())),
                     dtype=torch.int64)
    Xm, Xu = X[:, m.to(device)], X[:, u.to(device)]
    with full_f32_matmul():
        B11 = torch.bmm(Xm, Xm.transpose(1, 2))
        B21 = torch.bmm(Xu, Xm.transpose(1, 2))
    B11 = torch.tril(B11) + torch.tril(B11, -1).transpose(1, 2)
    B11.diagonal(dim1=1, dim2=2).fill_(1.0 + LAMBDA)
    z1 = torch.from_numpy((rng.standard_normal((W, Mp)) * 1.5).astype(
        np.float32)).to(device)
    return B11, torch.cat([B21.transpose(1, 2), z1[:, :, None]], dim=2)


def garbage_upper(B11, seed=32):
    """B11 with its strict upper triangle overwritten (a kernel that reads
    it gives wrong answers)."""
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        tuple(B11.shape)).astype(np.float32) * 1e3).to(B11.device)
    return torch.tril(B11) + torch.triu(g, 1)


def col_major(rhs):
    """rhs [W, Mp, K] in the layout corr_um_rhs returns on the card:
    column-major in each window."""
    out = torch.empty((rhs.shape[0], rhs.shape[2], rhs.shape[1]),
                      dtype=rhs.dtype, device=rhs.device).transpose(1, 2)
    out.copy_(rhs)
    return out


def normwise(got, ref):
    got = torch.as_tensor(np.asarray(got, np.float64))
    ref = torch.as_tensor(np.asarray(ref, np.float64))
    return float((got - ref).abs().max() / ref.abs().max())


def fail_windows(B11, where):
    """B11 with window w's pivot p (0-based) made negative or NaN, for
    each (w, p, value) in ``where``."""
    B11 = B11.clone()
    for w, p, v in where:
        B11[w, p, p] = v
    return B11


@pytest.mark.parametrize("W,Mp,Up", [(3, 512, 64), (2, 128, 64)])
def test_plain_matches_gauss_tpu_blocked(W, Mp, Up):
    """Y and L against gauss_tpu's blocked algorithm (Mp = 512: two
    256-wide blocks, its blocked path; Mp = 128: its library fallback),
    reading B11's lower triangle only."""
    B11, rhs = blocks(W, Mp, Up)
    jL = jwk._blocked_cholesky_lower(jnp.asarray(B11.numpy()))
    jY = jwk._blocked_trsm_lower(jL, jnp.asarray(rhs.numpy()))
    Y, L, info = region_tail.cholesky_solve(garbage_upper(B11), rhs,
                                            want_l=True)
    assert Y.shape == (W, Mp, Up + 1) and L.shape == (W, Mp, Mp)
    assert info.dtype == torch.int32 and (info == 0).all()
    assert normwise(L, jL) <= JAX_TOL
    assert normwise(Y, jY) <= JAX_TOL


def test_info_is_cholesky_ex_info():
    """info is the 1-based index of the first pivot that is not positive:
    in the first 64-wide block, in the third, NaN, in the last; the
    tails give those windows NaN and the others finite values."""
    B11, rhs = blocks(5, 256, 64)
    bad = fail_windows(B11, [(1, 10, -1.0), (2, 150, -1.0),
                             (3, 70, float("nan")), (4, 255, -5.0)])
    _, _, info = region_tail.cholesky_solve(bad, rhs)
    assert info.tolist() == [0, 11, 151, 71, 256]
    assert torch.equal(info, torch.linalg.cholesky_ex(bad)[1])
    z, zinfo = twk._impute_tail(bad, rhs)
    assert torch.isnan(z[1:]).all() and torch.isnan(zinfo[1:]).all()
    assert torch.isfinite(z[0]).all() and torch.isfinite(zinfo[0]).all()


def test_want_l_gives_l_with_zero_upper_triangle():
    """want_l: L lower triangular, its strict upper triangle exactly zero,
    L L^T = B11; without it no L."""
    B11, rhs = blocks(2, 128, 64)
    Y, L, _ = region_tail.cholesky_solve(garbage_upper(B11), rhs,
                                         want_l=True)
    assert (torch.triu(L, 1) == 0).all()
    assert normwise(L @ L.transpose(1, 2), B11) <= 1e-6
    assert normwise(L @ Y, rhs) <= 1e-6
    _, none, _ = region_tail.cholesky_solve(B11, rhs)
    assert none is None


def _fake_cuda(monkeypatch, lib):
    """FakeTensorMode with a fake CUDA device, the kernel library replaced
    by ``lib`` and the plain version by one that fails."""
    fake_mode = pytest.importorskip("torch._subclasses.fake_tensor")

    def plain(*a, **k):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(_build, "library", lib)
    monkeypatch.setattr(region_tail, "cholesky_solve_plain", plain)
    try:
        mode = fake_mode.FakeTensorMode()
        with mode:
            torch.empty(1, device="cuda")
    except Exception as e:           # no fake CUDA device in this build
        pytest.skip(f"cannot make a fake CUDA tensor here: {e}")
    return mode


def test_cholesky_solve_refuses_what_the_kernel_does_not_take(monkeypatch):
    """On fake CUDA tensors the wrapper's checks raise before any launch:
    a row-major right-hand side, Mp not a multiple of 64, B11 of another
    shape, no column."""
    class Lib:
        def gauss_chol_solve(self, *a):
            raise AssertionError("a refused call reached the kernel")

    mode = _fake_cuda(monkeypatch, Lib)
    with mode:
        def z(*shape):
            return torch.zeros(shape, device="cuda")

        def cm(W, Mp, K):
            return z(W, K, Mp).transpose(1, 2)

        bad = [((z(2, 128, 128), z(2, 128, 65)), "column-major"),
               ((z(2, 96, 96), cm(2, 96, 65)), "multiples"),
               ((z(2, 128, 64), cm(2, 128, 65)), "shapes"),
               ((z(2, 128, 128), cm(2, 128, 0)), "shapes")]
        for args, what in bad:
            with pytest.raises(ValueError, match=what):
                region_tail.cholesky_solve(*args)


# -- the kernel's arithmetic, emulated -----------------------------------------

def tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does: to nearest, ties away
    from zero (sign and magnitude: add half of the 13 dropped bits' unit to
    the magnitude, then clear them)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tile_products(a, b, x3):
    """a b^T as the kernel's tensor cores form it, f32 sums: 3xTF32 (lo hi
    + hi lo + hi hi, hi = tf32(x), lo = tf32(x - hi)) or, the control,
    hi hi alone (what the TF32 switch asks for)."""
    ah, bh = tf32(a), tf32(b)
    if not x3:
        return ah @ bh.T
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh.T + ah @ bl.T + ah @ bh.T


def take_off(P, A, B, x3, T=64):
    """P - A B^T as the kernel forms it: each 64 k of products summed
    apart and taken off P with Kahan's compensation."""
    C = torch.zeros_like(P)
    for k0 in range(0, A.shape[1], T):
        y = -tile_products(A[:, k0:k0 + T], B[:, k0:k0 + T], x3) - C
        t = P + y
        C = (t - P) - y
        P = t
    return P - C


def emulated_solve(B11, rhs, x3, T=64):
    """(Y, L) of one window [Mp, Mp], [Mp, K] float32 by the kernel's
    algorithm: left-looking by T-wide block columns, each tile's products
    by take_off, the in-tile steps (the tile's Cholesky, the panel's and
    the solve's substitutions) in float32."""
    Mp = B11.shape[0]
    L, Y = torch.zeros_like(B11), rhs.clone()
    for j in range(Mp // T):
        s, r = slice(j * T, (j + 1) * T), slice((j + 1) * T, Mp)
        D = take_off(B11[s, s], L[s, :j * T], L[s, :j * T], x3)
        L[s, s] = torch.linalg.cholesky(torch.tril(D) + torch.tril(D, -1).T)
        C = take_off(B11[r, s], L[r, :j * T], L[s, :j * T], x3)
        L[r, s] = torch.linalg.solve_triangular(L[s, s], C.T, upper=False).T
    for j in range(Mp // T):
        s = slice(j * T, (j + 1) * T)
        R = take_off(Y[s].T, Y[:j * T].T, L[s, :j * T], x3).T
        Y[s] = torch.linalg.solve_triangular(L[s, s], R, upper=False)
    return Y, L


@pytest.mark.parametrize("x3", [True, False], ids=["3xTF32", "1xTF32"])
def test_emulated_tile_products_against_float64(x3):
    """One window at the main path's widths (Mp = 1280, K = 961): with
    3xTF32 products and the compensation the blocked solve's Y and L are
    within SOLVE_ACC (chip_smoke's bar on the card) of the library pair's
    distance from a float64 solve; with 1xTF32 products (the control) both
    are far past it."""
    B11, rhs = blocks(1, 1280, 960)
    B11, rhs = garbage_upper(B11)[0], rhs[0]
    L64 = torch.linalg.cholesky(torch.tril(B11).double()
                                + torch.tril(B11, -1).double().T)
    Y64 = torch.linalg.solve_triangular(L64, rhs.double(), upper=False)
    pY, pL, _ = region_tail.cholesky_solve_plain(B11[None], rhs[None], True)
    Y, L = emulated_solve(B11, rhs, x3)
    ratios = (normwise(Y, Y64) / normwise(pY[0], Y64),
              normwise(L, L64) / normwise(pL[0], L64))
    if x3:
        assert max(ratios) <= SOLVE_ACC, ratios
    else:
        assert min(ratios) > 10 * SOLVE_ACC, ratios


def test_solve_bounds_at_the_main_path_shape():
    """chip_smoke.solve_bounds at W = 43, Mp = 1280, K = 961: 97.76 GFLOP,
    3x that at the TF32 peak 0.593 ms, the f32 bound 1.459 ms, 564 MB of
    bytes (L too with want_l)."""
    t_ms, f_ms, b_ms, gflop, mb = solve_bounds(43, 1280, 961, False)
    assert abs(gflop - 97.763) < 1e-3 and abs(mb - 564.16) < 0.01
    assert abs(t_ms - 0.5925) < 1e-4 and abs(f_ms - 1.4591) < 1e-4
    assert abs(b_ms - mb * 1e6 / 3.35e12 * 1e3) < 1e-9
    with_l = solve_bounds(43, 1280, 961, True)[4]
    assert abs(with_l - (mb + 4 * 43 * 1280 ** 2 / 1e6)) < 1e-6


# -- on the card --------------------------------------------------------------

#: (W, Mp, Up): a small slab, more tiles than SMs, one window of the main
#: path's widths (the device impute_window), the main path's slab
GPU_SHAPES = {"W3-Mp128-Up64": (3, 128, 64), "W16-Mp768-Up512": (16, 768, 512),
              "W1-Mp1280-Up960": (1, 1280, 960),
              "W43-Mp1280-Up960": (43, 1280, 960)}


def _gpu_blocks(shape, seed=31):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return blocks(*GPU_SHAPES[shape], seed=seed, device="cuda")


def _kernel(B11, rhs, want_l):
    """The kernel on copies of B11 (garbage upper triangle) and a
    column-major rhs: (Y, L, info, launches)."""
    region_tail.launches["cholesky_solve"] = 0
    Y, L, info = region_tail.cholesky_solve(garbage_upper(B11),
                                            col_major(rhs), want_l)
    torch.cuda.synchronize()
    return Y, L, info, region_tail.launches["cholesky_solve"]


@pytest.mark.gpu
@pytest.mark.parametrize("want_l", [False, True])
@pytest.mark.parametrize("shape", list(GPU_SHAPES))
def test_kernel_matches_plain_on_gpu(shape, want_l):
    """Y (and L) within GPU_TOL of the library pair, normwise; info equal;
    with want_l L's strict upper triangle exactly zero; one launch."""
    B11, rhs = _gpu_blocks(shape)
    with full_f32_matmul():
        Y, L, info, n = _kernel(B11, rhs, want_l)
        pY, pL, pinfo = region_tail.cholesky_solve_plain(B11, rhs, True)
    assert n == 1 and torch.equal(info, pinfo) and (info == 0).all()
    assert Y.stride(1) == 1
    assert normwise(Y.cpu(), pY.cpu()) <= GPU_TOL
    if want_l:
        assert (torch.triu(L, 1) == 0).all()
        assert normwise(L.cpu(), pL.cpu()) <= GPU_TOL
    else:
        assert L is None


@pytest.mark.gpu
def test_kernel_info_and_nan_windows_on_gpu():
    """Windows that fail in the first, third and last 64-wide blocks and at
    a NaN pivot: info equal to LAPACK's (cholesky_ex on the CPU) and to the
    card's library except at the NaN pivot, which the card's cholesky_ex
    lets through (info 0); the impute tail gives those windows NaN and the
    others finite values, Y within GPU_TOL of the plain version's."""
    B11, rhs = _gpu_blocks("W16-Mp768-Up512")
    bad = fail_windows(B11, [(1, 10, -1.0), (5, 150, -1.0),
                             (9, 300, float("nan")), (15, 767, -5.0)])
    with full_f32_matmul():
        Y, _, info, _ = _kernel(bad, rhs, False)
        pY, _, pinfo = region_tail.cholesky_solve_plain(bad, rhs)
        z = twk._impute_tail(garbage_upper(bad), col_major(rhs)).cpu()
    info, pinfo = info.cpu(), pinfo.cpu()
    assert info.tolist() == [0, 11] + [0] * 3 + [151] + [0] * 3 + [301] \
        + [0] * 5 + [768]
    assert torch.equal(info, torch.linalg.cholesky_ex(bad.cpu())[1])
    nan = torch.arange(16) == 9
    assert torch.equal(info[~nan], pinfo[~nan])
    ok = info == 0
    assert torch.isnan(z[:, ~ok]).all() and torch.isfinite(z[:, ok]).all()
    assert normwise(Y[ok.cuda()].cpu(), pY[ok.cuda()].cpu()) <= GPU_TOL


@pytest.mark.gpu
def test_kernel_follows_the_tf32_switch_on_gpu():
    """With allow_tf32 on and no full_f32_matmul around it, the kernel
    rounds its tile products' operands to TF32: Y moves from the f32
    result by a TF32-sized amount (well above the f32 noise between kernel
    and library, well below the values)."""
    B11, rhs = _gpu_blocks("W16-Mp768-Up512")
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        f32 = _kernel(B11, rhs, False)[0]
        plain = region_tail.cholesky_solve_plain(B11, rhs)[0]
        torch.backends.cuda.matmul.allow_tf32 = True
        tf = _kernel(B11, rhs, False)[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    noise = normwise(f32.cpu(), plain.cpu())
    moved = normwise(tf.cpu(), f32.cpu())
    assert max(1e-6, 10 * noise) < moved < 1e-1, (noise, moved)


def _bad_slab(B11):
    """B11 with window 1 indefinite at a middle pivot and window 2's pivot
    at 3/4 NaN, and the info they must give."""
    W, Mp, _ = B11.shape
    p, q = Mp // 2 + 5, 3 * Mp // 4 + 7
    want = [0] * W
    want[1], want[2] = p + 1, q + 1
    return fail_windows(B11, [(1, p, -1.0), (2, q, float("nan"))]), want


@pytest.mark.gpu
@pytest.mark.parametrize("want_l", [False, True])
def test_kernel_failed_windows_leave_the_others_alone_on_gpu(want_l):
    """A slab with an indefinite and a NaN window returns, info names their
    pivots, and every other window's Y (and L) is bit-equal to the same
    slab's without them."""
    B11, rhs = _gpu_blocks("W16-Mp768-Up512")
    bad, want = _bad_slab(B11)
    with full_f32_matmul():
        Y, L, info, _ = _kernel(B11, rhs, want_l)
        bY, bL, binfo, _ = _kernel(bad, rhs, want_l)
    assert binfo.tolist() == want and (info == 0).all()
    ok = torch.tensor(want, device="cuda") == 0
    assert torch.equal(bY[ok], Y[ok])
    if want_l:
        assert torch.equal(bL[ok], L[ok])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", ["W16-Mp768-Up512", "W43-Mp1280-Up960"])
def test_kernel_bit_equal_between_runs_on_gpu(shape):
    """Two calls on the same blocks give the same bits (no sum whose order
    depends on which block runs which tile)."""
    B11, rhs = _gpu_blocks(shape)
    with full_f32_matmul():
        Y1, L1, info1, _ = _kernel(B11, rhs, True)
        Y2, L2, info2, _ = _kernel(B11, rhs, True)
    assert torch.equal(Y1, Y2) and torch.equal(L1, L2)
    assert torch.equal(info1, info2)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [1, 7])
def test_kernel_window_independent_of_slab_width_on_gpu(width):
    """Windows 3 .. 3 + width of a 16-window slab, solved as a slab of
    their own, are bit-equal to their rows of the whole slab's solve."""
    B11, rhs = _gpu_blocks("W16-Mp768-Up512")
    part = slice(3, 3 + width)
    with full_f32_matmul():
        Y, L, _, _ = _kernel(B11, rhs, True)
        pY, pL, _, _ = _kernel(B11[part].contiguous(),
                               rhs[part].contiguous(), True)
    assert torch.equal(pY, Y[part]) and torch.equal(pL, L[part])

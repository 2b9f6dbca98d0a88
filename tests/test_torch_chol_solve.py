"""The region tail's Cholesky factorization and forward solve
(gauss_tpu_torch.ops.region_tail.cholesky_solve, csrc/chol_solve.cu).

On the CPU its plain version (the library pair cholesky_ex +
solve_triangular) against gauss_tpu's blocked Cholesky and triangular
solve (ops/window_kernel._blocked_cholesky_lower / _blocked_trsm_lower) on
the same seeded blocks, info as cholesky_ex gives it, and the wrapper's
refusals on fake CUDA tensors; on the card (``gpu``) the kernel against
its plain version.

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

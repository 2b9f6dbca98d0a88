"""The region tails' hand kernels: the CalWgtCov correlation blocks, the
triangular solve's right-hand side, the Cholesky factorization and forward
solve, and z / info.

After K1 (``ops/gram.py``) a resident region kernel (``ops/window_kernel``)
turns each window's Grams into correlation blocks and solves them.
``csrc/region_tail.cu`` makes the blocks and reads the solve's output:

- ``corr_mm``: the measured block B11 [B, Mp, Mp] (impute, qcat and LD),
  with the rows' std and weighted means that the next block needs;
- ``corr_um_rhs``: B21 [B, Up, Mp] and Z1 as the solve's right-hand side
  ``[B21^T | Z1]`` [B, Mp, Up + 1] (impute and qcat);
- ``impute_finalize``: (z, info) [2, B, Up] from the solve's output, NaN
  where a window's factorization failed (impute).

``csrc/chol_solve.cu`` solves them:

- ``cholesky_solve``: B11 = L L^T and Y = L^-1 [B21^T | Z1], with
  cholesky_ex's info, written over B11 and the right-hand side (impute;
  qcat also takes L).

No Pallas kernel corresponds to them: gauss_tpu leaves this work to XLA at
Precision.HIGHEST (``gauss_tpu/ops/window_kernel.py:_resident_block_builder``,
``_blocked_cholesky_lower``, ``_blocked_trsm_lower`` and the tail of its
``build_resident_region_kernel``).  Each wrapper launches its kernel for
CUDA tensors and runs its plain PyTorch version, the torch code the kernel
replaced, for CPU tensors only.  The kernel's B11 is exactly symmetric and
its right-hand side column-major (the solve's own layout); the plain
versions give the same values, B11 symmetric to an ulp and the right-hand
side row-major.

TF32: the plain versions' sums over populations and rows are torch
matmuls, which round their operands to TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is on.  Each wrapper reads that
switch when it queues its kernel, which then rounds the same operands
(``cholesky_solve``: its tile products' L and Y tiles).  The resident
kernels call these under ``full_f32_matmul``: full f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build, gram

#: rows per tile side of the kernels: Mp and Up must be multiples
TILE = 64
#: kernel launches since the counts were last set to 0 (CUDA path only)
launches = {"corr_mm": 0, "corr_um_rhs": 0, "impute_finalize": 0,
            "cholesky_solve": 0}


def _slice_rows(A: torch.Tensor, offs: torch.Tensor, n: int) -> torch.Tensor:
    """Batched row slices A[offs[w] : offs[w] + n] -> [W, n, ...]."""
    rows = offs.to(torch.int64)[:, None] + torch.arange(n, device=A.device)
    return A[rows]


def _bmm_t(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.bmm(a, b.transpose(1, 2))


def _nan_where(failed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x with every window whose factorization failed set to NaN
    (failed: [W] bool, x: [W, ...])."""
    nan = torch.full((), float("nan"), dtype=x.dtype, device=x.device)
    return torch.where(failed.reshape((-1,) + (1,) * (x.dim() - 1)), nan, x)


def _std(var: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    one = torch.ones((), dtype=torch.float32, device=var.device)
    return torch.sqrt(torch.where(mask > 0, var, one))


def corr_mm_plain(T1, Spm, Mum, m_t0, m_mask, alpha, w, diag):
    """Plain PyTorch version of ``corr_mm``."""
    Mp = T1.shape[-1]
    sxm = _slice_rows(Spm, m_t0, Mp)                     # [W, Mp, P]
    mi_m = None
    if w is None:
        # cov = sum_s x'y' - S'x S'y / n  (= sum (x-xbar)(y-ybar))
        cov_mm = gram.mirror_lower(T1) - _bmm_t(sxm * alpha, sxm)
    else:
        mu_m = _slice_rows(Mum, m_t0, Mp)
        big_mm = gram.mirror_lower(T1) - _bmm_t(sxm * alpha, sxm)
        # mean-product terms + normalization (CalWgtCov tail)
        mi_m = mu_m @ w                                  # [W, Mp]
        cov_mm = (big_mm + _bmm_t(mu_m * w, mu_m)) \
            - mi_m[:, :, None] * mi_m[:, None, :]
    std_m = _std(torch.diagonal(cov_mm, dim1=1, dim2=2), m_mask)
    B11 = cov_mm / (std_m[:, :, None] * std_m[:, None, :])
    B11 = B11 * (m_mask[:, :, None] * m_mask[:, None, :])
    B11.diagonal(dim1=1, dim2=2).fill_(diag)
    return B11, std_m, mi_m


def corr_um_rhs_plain(T1, Spu, Muu, Vu, u_t0, Spm, Mum, m_t0, std_m, mi_m,
                      u_mask, m_mask, z1, alpha, w):
    """Plain PyTorch version of ``corr_um_rhs``."""
    Up, Mp = T1.shape[1], T1.shape[2]
    sxm = _slice_rows(Spm, m_t0, Mp)
    sxu = _slice_rows(Spu, u_t0, Up)
    vu_big = _slice_rows(Vu, u_t0, Up)                   # [W, Up]
    if w is None:
        cov_um = T1 - _bmm_t(sxu * alpha, sxm)
        var_u = vu_big
    else:
        mu_m = _slice_rows(Mum, m_t0, Mp)
        mu_u = _slice_rows(Muu, u_t0, Up)
        big_um = T1 - _bmm_t(sxu * alpha, sxm)
        mi_u = mu_u @ w
        cov_um = (big_um + _bmm_t(mu_u * w, mu_m)) \
            - mi_u[:, :, None] * mi_m[:, None, :]
        var_u = (vu_big + (mu_u * mu_u) @ w) - mi_u * mi_u
    std_u = _std(var_u, u_mask)
    B21 = cov_um / (std_u[:, :, None] * std_m[:, None, :])
    B21 = B21 * (u_mask[:, :, None] * m_mask[:, None, :])
    return torch.cat([B21.transpose(1, 2), z1[:, :, None]], dim=2)


def impute_finalize_plain(Yall, bad):
    """Plain PyTorch version of ``impute_finalize``."""
    Up = Yall.shape[2] - 1
    Y, y1 = Yall[:, :, :Up], Yall[:, :, Up]
    z2 = torch.einsum("wmu,wm->wu", Y, y1)
    info = (Y * Y).sum(dim=1)
    z = z2 / torch.sqrt(info)
    failed = bad != 0
    return torch.stack((_nan_where(failed, z), _nan_where(failed, info)))


def cholesky_solve_plain(B11, rhs, want_l=False):
    """Plain PyTorch version of ``cholesky_solve``: the library pair it
    replaced (cholesky_ex reads B11's lower triangle)."""
    L, info = torch.linalg.cholesky_ex(B11)
    Y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return Y, (L if want_l else None), info


def _check(name, tensors, dtypes=None):
    """The inputs' one device (None entries skipped); each float32 unless
    ``dtypes`` ({index: dtype}) names another."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {devs}")
    for k, t in enumerate(tensors):
        if t is None:
            continue
        want = (dtypes or {}).get(k, torch.float32)
        if t.dtype != want:
            raise TypeError(f"{name}: input {k} is {t.dtype}, not {want}")
    return devs.pop()


def _pack_scratch(lib, n_tiles: int, P: int, pooled: bool, dev):
    """The kernels' packed operands of ``n_tiles`` 64-row band tiles: each
    tile's rank-P panels [1 or 2, P, 64], then its rows' std, mi and mask
    [3, 64] (written by the kernel's pack pass, read by its tile pass)."""
    n = n_tiles * lib.gauss_region_pack_floats(P, int(pooled))
    return torch.empty((n,), dtype=torch.float32, device=dev)


def _tiles(name, *sizes):
    if any(n % TILE for n in sizes):
        raise ValueError(f"{name}: sizes {sizes} must be multiples of {TILE}")


def corr_mm(T1: torch.Tensor, Spm: torch.Tensor, Mum: torch.Tensor,
            m_t0: torch.Tensor, m_mask: torch.Tensor, alpha: torch.Tensor,
            w: Optional[torch.Tensor], diag: float):
    """The measured block of a slab of B windows:
    (B11 [B, Mp, Mp], std_m [B, Mp], mi_m [B, Mp] or None).

    T1: K1's sym Gram [B, Mp, Mp] (lower tiles valid); Spm / Mum: the
    resident measured rows' shifted population sums and means [R, P],
    window w's band at row m_t0[w] (int32 [B]); m_mask [B, Mp]; alpha [P]
    (pooled: [1] holding 1/n); w [P] the population weights, None when
    pooled.  Masked rows and columns are zero and the diagonal is ``diag``.
    std_m and mi_m (the rows' sum_k mu_k w_k) feed ``corr_um_rhs``.  CPU
    tensors take the plain version."""
    dev = _check("corr_mm", (T1, Spm, Mum, m_mask, alpha, w, m_t0),
                 {6: torch.int32})
    if dev.type == "cpu":
        return corr_mm_plain(T1, Spm, Mum, m_t0, m_mask, alpha, w, diag)
    ins = (T1, Spm, Mum, m_mask, alpha, w, m_t0)
    lib = _build.kernel_library("corr_mm", dev, ins)
    B, Mp, P = T1.shape[0], T1.shape[-1], Spm.shape[1]
    _tiles("corr_mm", Mp)
    if T1.shape != (B, Mp, Mp) or m_mask.shape != (B, Mp) \
            or m_t0.shape != (B,) or alpha.shape != (P,) \
            or (w is not None and w.shape != (P,)) or Mum.shape != Spm.shape:
        raise ValueError("corr_mm: inconsistent shapes")
    if T1.data_ptr() % 16:
        raise ValueError("corr_mm: T1 must be 16-byte aligned")
    out = torch.empty_like(T1)
    std = torch.empty((B, Mp), dtype=torch.float32, device=dev)
    mi = None if w is None else torch.empty_like(std)
    pack = _pack_scratch(lib, 2 * B * (Mp // TILE), P, w is None, dev)
    with torch.cuda.device(dev):
        err = lib.gauss_region_corr_mm(
            T1.data_ptr(), Spm.data_ptr(), Mum.data_ptr(), m_t0.data_ptr(),
            Spm.shape[0], m_mask.data_ptr(), alpha.data_ptr(), _build.ptr(w),
            P, B, Mp, float(diag), int(w is None),
            int(torch.backends.cuda.matmul.allow_tf32), std.data_ptr(),
            _build.ptr(mi), pack.data_ptr(), out.data_ptr(),
            _build.stream(dev))
    _build.check(err, "corr_mm")
    launches["corr_mm"] += 1
    return out, std, mi


def corr_um_rhs(T1: torch.Tensor, Spu: torch.Tensor, Muu: torch.Tensor,
                Vu: torch.Tensor, u_t0: torch.Tensor, Spm: torch.Tensor,
                Mum: torch.Tensor, m_t0: torch.Tensor, std_m: torch.Tensor,
                mi_m: Optional[torch.Tensor], u_mask: torch.Tensor,
                m_mask: torch.Tensor, z1: torch.Tensor, alpha: torch.Tensor,
                w: Optional[torch.Tensor]) -> torch.Tensor:
    """The solve's right-hand side [B21^T | Z1] [B, Mp, Up + 1] of a slab:
    rhs[b, m, u] = B21[b, u, m] for u < Up, rhs[b, :, Up] = z1[b].

    T1: K1's um Gram [B, Up, Mp]; Spu / Muu [Ru, P] and Vu [Ru] the
    resident unmeasured rows' statistics (band at u_t0[b]); Spm / Mum /
    m_t0 / alpha / w as ``corr_mm``, std_m and mi_m its outputs; u_mask
    [B, Up], m_mask and z1 [B, Mp].  On CUDA the result is column-major
    (strides ((Up + 1) Mp, 1, Mp)), the layout the triangular solve works
    in.  CPU tensors take the plain version."""
    ins = (T1, Spu, Muu, Vu, Spm, Mum, std_m, mi_m, u_mask, m_mask, z1,
           alpha, w, u_t0, m_t0)
    dev = _check("corr_um_rhs", ins, {13: torch.int32, 14: torch.int32})
    if dev.type == "cpu":
        return corr_um_rhs_plain(T1, Spu, Muu, Vu, u_t0, Spm, Mum, m_t0,
                                 std_m, mi_m, u_mask, m_mask, z1, alpha, w)
    lib = _build.kernel_library("corr_um_rhs", dev, ins)
    B, Up, Mp = T1.shape
    P = Spm.shape[1]
    _tiles("corr_um_rhs", Mp, Up)
    if std_m.shape != (B, Mp) or m_mask.shape != (B, Mp) \
            or z1.shape != (B, Mp) or u_mask.shape != (B, Up) \
            or u_t0.shape != (B,) or m_t0.shape != (B,) or Spu.shape[1] != P \
            or Muu.shape != Spu.shape or Vu.shape != Spu.shape[:1] \
            or (w is None) != (mi_m is None):
        raise ValueError("corr_um_rhs: inconsistent shapes")
    if T1.data_ptr() % 16:
        raise ValueError("corr_um_rhs: T1 must be 16-byte aligned")
    out = torch.empty((B, Up + 1, Mp), dtype=torch.float32, device=dev)
    scratch = _pack_scratch(lib, B * ((Up + Mp) // TILE), P, w is None, dev)
    with torch.cuda.device(dev):
        err = lib.gauss_region_corr_um_rhs(
            T1.data_ptr(), Spu.data_ptr(), Muu.data_ptr(), Vu.data_ptr(),
            u_t0.data_ptr(), Spu.shape[0], Spm.data_ptr(), Mum.data_ptr(),
            m_t0.data_ptr(), Spm.shape[0], std_m.data_ptr(), _build.ptr(mi_m),
            u_mask.data_ptr(), m_mask.data_ptr(), z1.data_ptr(),
            alpha.data_ptr(), _build.ptr(w), P, B, Mp, Up, int(w is None),
            int(torch.backends.cuda.matmul.allow_tf32), scratch.data_ptr(),
            out.data_ptr(), _build.stream(dev))
    _build.check(err, "corr_um_rhs")
    launches["corr_um_rhs"] += 1
    return out.transpose(1, 2)


def impute_finalize(Yall: torch.Tensor, bad: torch.Tensor) -> torch.Tensor:
    """(z, info) [2, B, Up] from the solve's output Yall = L^-1 [B21^T | Z1]
    [B, Mp, Up + 1], column-major in each window as ``solve_triangular``
    returns it (middle stride 1; anything else raises): info = colsum(Y^2),
    z = (Y^T y1) / sqrt(info) with y1 its last column; NaN for both in every
    window whose ``bad`` (cholesky_ex's info, int32 [B]) is not 0.  CPU
    tensors take the plain version."""
    dev = _check("impute_finalize", (Yall, bad), {1: torch.int32})
    if Yall.dim() != 3 or Yall.stride(1) != 1:
        raise ValueError("impute_finalize: Yall must be column-major in each "
                         f"window (strides {tuple(Yall.stride())})")
    if dev.type == "cpu":
        return impute_finalize_plain(Yall, bad)
    lib = _build.kernel_library("impute_finalize", dev, (bad,))
    B, Mp, Up1 = Yall.shape
    if bad.shape != (B,) or Up1 < 1:
        raise ValueError("impute_finalize: inconsistent shapes")
    out = torch.empty((2, B, Up1 - 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gauss_region_finalize(
            Yall.data_ptr(), Yall.stride(0), Yall.stride(2), bad.data_ptr(),
            B, Mp, Up1 - 1,
            int(torch.backends.cuda.matmul.allow_tf32), out.data_ptr(),
            _build.stream(dev))
    _build.check(err, "impute_finalize")
    launches["impute_finalize"] += 1
    return out


def cholesky_solve(B11: torch.Tensor, rhs: torch.Tensor, want_l: bool = False):
    """(Y, L or None, info) of a slab of B windows: B11 = L L^T from B11's
    lower triangle [B, Mp, Mp], Y = L^-1 rhs [B, Mp, K], info int32 [B] as
    cholesky_ex gives it (0, or the 1-based index of the first pivot that
    is not positive or is NaN).  L, lower triangular with a zero strict
    upper triangle, only when ``want_l``.

    On CUDA both are written in place: Y over rhs, which must be
    column-major in each window as ``corr_um_rhs`` returns it (strides
    (K Mp, 1, Mp)), and L over B11 (contiguous; without ``want_l`` only its
    lower triangle is meaningful afterwards); a window whose factorization
    failed has unspecified Y and L.  Callers take the returned tensors and
    treat B11 and rhs as consumed.  One launch on the current stream; the
    only scratch is the kernel's zeroed int32 progress counters, info the
    first B of them.  CPU tensors take the plain version."""
    dev = _check("cholesky_solve", (B11, rhs))
    if dev.type == "cpu":
        return cholesky_solve_plain(B11, rhs, want_l)
    lib = _build.kernel_library("cholesky_solve", dev, (B11,))
    if B11.dim() != 3 or rhs.dim() != 3:
        raise ValueError("cholesky_solve: B11 and rhs must be [B, Mp, .]")
    B, Mp, K = rhs.shape
    _tiles("cholesky_solve", Mp)
    if B11.shape != (B, Mp, Mp) or K < 1:
        raise ValueError("cholesky_solve: inconsistent shapes "
                         f"{tuple(B11.shape)}, {tuple(rhs.shape)}")
    if rhs.stride() != (K * Mp, 1, Mp):
        raise ValueError("cholesky_solve: rhs must be column-major in each "
                         f"window (strides {tuple(rhs.stride())})")
    if B11.data_ptr() % 16 or rhs.data_ptr() % 16:
        raise ValueError("cholesky_solve: B11 and rhs must be 16-byte "
                         "aligned")
    flags = torch.zeros((lib.gauss_chol_solve_flags(B, Mp, K),),
                        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gauss_chol_solve(
            B11.data_ptr(), rhs.data_ptr(), flags.data_ptr(), B, Mp, K,
            int(want_l), int(torch.backends.cuda.matmul.allow_tf32),
            _build.stream(dev))
    _build.check(err, "cholesky_solve")
    launches["cholesky_solve"] += 1
    return rhs, (B11 if want_l else None), flags[:B]

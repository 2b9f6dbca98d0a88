"""The gene path's hand kernels: per-population partials of a bucket of
gene blocks, and the float64 combine behind jepeg / jepegmix's gene
statistics.

``core/genekernels`` gathers each power-of-two bucket of gene rows with K2
(``ops/gather.py``) and hands the int8 block [B, n, S] here.
``csrc/gene_stats.cu`` computes:

- ``gene_partials``: C [P, B, n, n], S [P, B, n] and Q [P, B, n], each
  segment's Gram, row sums and sums of squares, exact integers in float32
  (dosages 0..2: every sum stays below 2^24 while 4 m_k < 2^24);
- ``gene_stats_tail``: from those, the float64 CalWgtCov combine in the
  reference's population order (src/util.cpp:49-70, 103-124), the pad
  rows' pairs zeroed, the 1 + lambda ridge diagonal (src/gene.cpp:569-586)
  and CovU = W R W^T, WWt = W W^T, U = W z (src/gene.cpp:594-648), R never
  stored; ``gene_corr`` runs the same kernel for the correlations CorG
  [B, n, n] alone (no mask, no ridge).

No Pallas kernel corresponds to them: gauss_tpu leaves this work to XLA
(``gauss_tpu/core/genekernels.py:_gene_stats_body``, jitted in
``_gene_stats_unsharded``).  Each wrapper launches its kernel for CUDA
tensors and runs its plain PyTorch version, the torch code the kernel
replaced, for CPU tensors only.  On the card the kernel's partials equal
the plain version's bits, and so does CorG (each float64 step one
correctly rounded operation in the plain order, divisions by a population
size taken as PyTorch's CUDA division by a scalar takes them, times its
reciprocal); CovU, WWt and U sum in another order.  The kernels are
integer and float64 arithmetic: the TF32 switches do not reach them.  The
plain partials are float32 matmuls of exact integers; callers queue them
under ``full_f32_matmul``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import _build

#: kernel launches since the counts were last set to 0 (CUDA path only)
#: (gene_corr: the tail kernel in its correlation mode)
launches = {"gene_partials": 0, "gene_stats_tail": 0, "gene_corr": 0}
#: populations (segments) a launch takes at most
MAX_POPS = 64


def gene_partials_plain(Gb: torch.Tensor, bounds: np.ndarray):
    """Plain PyTorch version of ``gene_partials``."""
    g = Gb.to(torch.float32)
    Cs, Ss, Qs = [], [], []
    for k in range(len(bounds) - 1):
        gk = g[:, :, int(bounds[k]):int(bounds[k + 1])]
        Cs.append(gk @ gk.transpose(1, 2))
        Ss.append(gk.sum(dim=2))
        Qs.append((gk * gk).sum(dim=2))
    return torch.stack(Cs), torch.stack(Ss), torch.stack(Qs)


def gene_corr_plain(C, S, Q, true_sizes, wgts) -> torch.Tensor:
    """Plain PyTorch version of ``gene_corr``."""
    f64 = dict(dtype=torch.float64, device=C.device)
    if wgts is None:
        n = float(sum(int(x) for x in true_sizes))
        C0 = C.sum(dim=0).to(torch.float64)
        s64 = S.sum(dim=0).to(torch.float64)
        q64 = Q.sum(dim=0).to(torch.float64)
        numer = n * C0 - s64[:, :, None] * s64[:, None, :]
        d = torch.sqrt(n * q64 - s64 * s64)
        return numer / (d[:, :, None] * d[:, None, :])
    m = np.asarray(true_sizes, dtype=np.float64)
    w = np.asarray(wgts, dtype=np.float64)
    factor = m / (m - 1.0)
    B, n = C.shape[1], C.shape[2]
    cov = torch.zeros((B, n, n), **f64)
    mimj = torch.zeros((B, n, n), **f64)
    mi = torch.zeros((B, n), **f64)
    var = torch.zeros((B, n), **f64)
    vmimj = torch.zeros((B, n), **f64)
    vmi = torch.zeros((B, n), **f64)
    for k in range(len(m)):
        wf, mk, wk = float(w[k] * factor[k]), float(m[k]), float(w[k])
        Ck = C[k].to(torch.float64)
        s = S[k].to(torch.float64)
        q = Q[k].to(torch.float64)
        cov = cov + wf * (mk * Ck - s[:, :, None] * s[:, None, :])
        mimj = mimj + (wk * (s / mk))[:, :, None] * (s / mk)[:, None, :]
        mi = mi + wk * (s / mk)
        var = var + wf * (mk * q - s * s)
        vmimj = vmimj + (wk * (s / mk)) * (s / mk)
        vmi = vmi + wk * (s / mk)
    cov = (cov + mimj) - mi[:, :, None] * mi[:, None, :]
    std = torch.sqrt((var + vmimj) - vmi * vmi)
    return cov / (std[:, :, None] * std[:, None, :])


def gene_stats_tail_plain(C, S, Q, true_sizes, wgts, ids, Wz, lam):
    """Plain PyTorch version of ``gene_stats_tail``."""
    B, npad = C.shape[1], C.shape[2]
    real = (ids >= 0).reshape(B, npad)
    Wb = Wz[:, :6].reshape(B, npad, 6).transpose(1, 2)
    zb = Wz[:, 6].reshape(B, npad)
    CorG = gene_corr_plain(C, S, Q, true_sizes, wgts)
    CorG = torch.where(real[:, :, None] & real[:, None, :], CorG, 0.0)
    # the ridge diagonal as the reference writes it: a real SNP's NaN
    # diagonal stays NaN (NaN * 0)
    eye = torch.eye(npad, dtype=torch.float64, device=C.device)
    CorG = CorG * (1.0 - eye) + (1.0 + lam) * eye
    WCor = torch.einsum("bkn,bnm->bkm", Wb, CorG)
    return (torch.einsum("bkm,bjm->bkj", WCor, Wb),
            torch.einsum("bkn,bjn->bkj", Wb, Wb),
            torch.einsum("bkn,bn->bk", Wb, zb))


def _partials_shape(C, S, Q):
    """(P, B, n) of matching float32 partials; raises otherwise."""
    if C.dim() != 4 or C.shape[2] != C.shape[3]:
        raise ValueError(f"C must be [P, B, n, n], got {tuple(C.shape)}")
    P, B, n = C.shape[:3]
    if S.shape != (P, B, n) or Q.shape != (P, B, n):
        raise ValueError("gene statistics: C, S and Q disagree in shape")
    for t in (C, S, Q):
        if t.dtype != torch.float32:
            raise TypeError(f"partials must be float32, got {t.dtype}")
    if len({t.device for t in (C, S, Q)}) != 1:
        raise ValueError("partials on several devices")
    return P, B, n


def _sizes_ok(name, n, P):
    if n < 8 or n & (n - 1):
        raise ValueError(f"{name}: bucket size {n} is not a power of two "
                         ">= 8")
    if not 1 <= P <= MAX_POPS:
        raise ValueError(f"{name}: {P} segments (at most {MAX_POPS})")


def gene_partials(Gb: torch.Tensor, bounds: np.ndarray):
    """(C [P, B, n, n], S [P, B, n], Q [P, B, n]) float32 of the int8 gene
    blocks Gb [B, n, S_cols] over the P column segments [bounds[k],
    bounds[k + 1]): each segment's Gram, row sums and sums of squares,
    exact integers.  Columns past bounds[-1] are never read.  On CUDA, n
    is a power of two >= 8 (a bucket size), S_cols a multiple of 16 and Gb
    contiguous and 16-byte aligned.  CPU tensors take the plain version."""
    if Gb.dtype != torch.int8 or Gb.dim() != 3:
        raise TypeError(f"Gb must be a 3-D int8 tensor, got {Gb.dtype} "
                        f"{tuple(Gb.shape)}")
    dev = Gb.device
    if dev.type == "cpu":
        return gene_partials_plain(Gb, bounds)
    lib = _build.kernel_library("gene_partials", dev, (Gb,))
    B, n, S = Gb.shape
    P = len(bounds) - 1
    _sizes_ok("gene_partials", n, P)
    b = [int(x) for x in bounds]
    if S % 16 or Gb.data_ptr() % 16:
        raise ValueError("gene_partials: rows must be a multiple of 16 "
                         "bytes and 16-byte aligned")
    if b[0] < 0 or b[-1] > S or any(x > y for x, y in zip(b, b[1:])):
        raise ValueError(f"gene_partials: bounds {b} outside [0, {S}]")
    C = torch.empty((P, B, n, n), dtype=torch.float32, device=dev)
    Ssum = torch.empty((P, B, n), dtype=torch.float32, device=dev)
    Q = torch.empty((P, B, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gauss_gene_partials(
            Gb.data_ptr(), S, B, n, P, (ctypes.c_int * (P + 1))(*b),
            C.data_ptr(), Ssum.data_ptr(), Q.data_ptr(), _build.stream(dev))
    _build.check(err, "gene_partials")
    launches["gene_partials"] += 1
    return C, Ssum, Q


def _consts(P, true_sizes, wgts):
    """The combine's scalars as the plain version forms them: (pooled,
    consts [wf, m, w, 1 / m] x P or None, the pooled sum of the sizes)."""
    if wgts is None:
        return True, None, float(sum(int(x) for x in true_sizes))
    m = np.asarray(true_sizes, dtype=np.float64)
    w = np.asarray(wgts, dtype=np.float64)
    if m.shape != (P,) or w.shape != (P,):
        raise ValueError(f"gene statistics: {len(m)} sizes and {len(w)} "
                         f"weights for {P} populations")
    factor = m / (m - 1.0)
    vals = ([float(w[k] * factor[k]) for k in range(P)]
            + [float(x) for x in m] + [float(x) for x in w]
            + [1.0 / float(x) for x in m])
    return False, (ctypes.c_double * (4 * P))(*vals), 0.0


def gene_corr(C: torch.Tensor, S: torch.Tensor, Q: torch.Tensor,
              true_sizes: Sequence[int],
              wgts: Optional[Sequence[float]]) -> torch.Tensor:
    """Gene correlation matrices CorG [B, n, n] float64 from the partials
    of ``gene_partials``: pooled CalCor (wgts None) or the CalWgtCov-based
    correlation over the P populations of true sizes ``true_sizes``,
    accumulated in the reference's population order.  CPU tensors take
    the plain version."""
    P, B, n = _partials_shape(C, S, Q)
    dev = C.device
    if dev.type == "cpu":
        return gene_corr_plain(C, S, Q, true_sizes, wgts)
    lib = _build.kernel_library("gene_corr", dev, (C, S, Q))
    _sizes_ok("gene_corr", n, P)
    pooled, consts, npool = _consts(P, true_sizes, wgts)
    out = torch.empty((B, n, n), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):
        err = lib.gauss_gene_tail(
            C.data_ptr(), S.data_ptr(), Q.data_ptr(), P, B, n, int(pooled),
            consts, npool, 0.0, None, None, out.data_ptr(), None, None, None,
            None, 0, _build.stream(dev))
    _build.check(err, "gene_corr")
    launches["gene_corr"] += 1
    return out


def gene_stats_tail(C: torch.Tensor, S: torch.Tensor, Q: torch.Tensor,
                    true_sizes: Sequence[int],
                    wgts: Optional[Sequence[float]], ids: torch.Tensor,
                    Wz: torch.Tensor, lam: float
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(CovU [B, 6, 6], WWt [B, 6, 6], U [B, 6]) float64 of a bucket of B
    genes from the partials of ``gene_partials`` (as ``gene_corr``): R =
    CorG with every pair touching a pad row set to 0 (a select: a pad
    row's NaN never reaches CovU, a real row's NaN does) and its diagonal
    CorG * 0 + (1 + lam), then CovU = W R W^T, WWt = W W^T, U = W z.

    ids: int32 [B n], the bucket's panel rows gene by gene (< 0 on pad
    rows); Wz: float64 [B n, 7] in the same row layout, W^T in columns
    0-5 and z in column 6.  CPU tensors take the plain version."""
    P, B, n = _partials_shape(C, S, Q)
    if ids.dtype != torch.int32 or ids.shape != (B * n,):
        raise ValueError(f"ids must be int32 [{B * n}], got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if Wz.dtype != torch.float64 or Wz.shape != (B * n, 7):
        raise ValueError(f"Wz must be float64 [{B * n}, 7], got "
                         f"{Wz.dtype} {tuple(Wz.shape)}")
    dev = C.device
    if ids.device != dev or Wz.device != dev:
        raise ValueError("gene_stats_tail: inputs on several devices")
    if dev.type == "cpu":
        return gene_stats_tail_plain(C, S, Q, true_sizes, wgts, ids, Wz,
                                     lam)
    lib = _build.kernel_library("gene_stats_tail", dev, (C, S, Q, ids, Wz))
    _sizes_ok("gene_stats_tail", n, P)
    pooled, consts, npool = _consts(P, true_sizes, wgts)
    f64 = dict(dtype=torch.float64, device=dev)
    CovU, WWt, U = (torch.empty((B, 6, 6), **f64),
                    torch.empty((B, 6, 6), **f64), torch.empty((B, 6), **f64))
    tiles = lib.gauss_gene_tail_tiles(n)
    scratch = tickets = None
    if tiles > 1:
        scratch = torch.empty((B * tiles * 36,), **f64)
        tickets = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.gauss_gene_tail(
            C.data_ptr(), S.data_ptr(), Q.data_ptr(), P, B, n, int(pooled),
            consts, npool, 1.0 + lam, ids.data_ptr(), Wz.data_ptr(),
            CovU.data_ptr(), WWt.data_ptr(), U.data_ptr(),
            _build.ptr(scratch), _build.ptr(tickets), 1, _build.stream(dev))
    _build.check(err, "gene_stats_tail")
    launches["gene_stats_tail"] += 1
    return CovU, WWt, U

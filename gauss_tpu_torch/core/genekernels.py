"""Gene-batched correlation statistics for jepeg/jepegmix.

Genes are independent small problems (the reference loops them serially,
src/jepeg.cpp:114-131).  Here genes are padded into power-of-two size
buckets and each bucket's SNP x SNP statistics are batched: exact
integer sufficient statistics per population in float32 (dosages 0..2,
so every partial sum stays an integer below 2^24 while 4 m_k < 2^24),
combined in float64 in the reference's population order.  Both steps are
``ops/gene_stats``: ``gene_partials`` (one launch per bucket and subject
shard on a card) and ``gene_corr`` / ``gene_stats_tail`` (one per
bucket).

Two paths:

* the per-call path (``gene_corr_matrices``): int8 gene blocks from the
  host in, float64 correlation matrices out as numpy, computed on the
  caller's device (default ``cuda``);
* the device path (``gene_stats_resident``, ``gene_corr_resident``): gene
  rows gathered by K2 (``ops/gather.py``) from the panel resident on the
  engine's device, one gather per bucket, the per-gene category
  statistics of jepeg computed there.  Pad rows use K2's -1 sentinel (zero
  rows) and their pairs are masked by a select: a pad row's NaN never
  reaches CovU, a NaN among a gene's real SNPs still propagates.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import stats
from .stats import full_f32_matmul
from ..ops import gene_stats
from ..ops.gather import gather_rows


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _buckets(sizes: Sequence[int], S: int, max_batch_elems: int
             ) -> List[Tuple[int, List[int]]]:
    """(npad, gene ids) per bucket: genes by size (stable), one bucket per
    padded size, split so that a bucket holds at most max_batch_elems
    int8 elements (a larger gene still gets a bucket of its own)."""
    order = np.argsort(np.asarray(sizes, dtype=np.int64), kind="stable")
    out = []
    i = 0
    while i < len(order):
        npad = _bucket(int(sizes[order[i]]))
        batch = []
        while (i < len(order) and _bucket(int(sizes[order[i]])) == npad
               and (not batch
                    or (len(batch) + 1) * npad * S <= max_batch_elems)):
            batch.append(int(order[i]))
            i += 1
        out.append((npad, batch))
    return out


def _stat_bounds(pop_sizes, wgts) -> np.ndarray:
    """Segments of the partial statistics: one per population when
    weighted; one over all of them when pooled (the pooled combine reads
    only their sums, which are exact either way)."""
    if wgts is None:
        return np.asarray([0, sum(int(x) for x in pop_sizes)])
    return stats.segment_bounds(pop_sizes)


def gene_corr_matrices(
    gene_G: List[np.ndarray],
    pop_sizes: Sequence[int],
    wgts: Optional[Sequence[float]] = None,
    max_batch_elems: int = 1 << 26,
    device="cuda",
) -> List[np.ndarray]:
    """Correlation matrix per gene, batched by padded size bucket, each
    bucket's products and combines on ``device`` (default ``cuda``; no
    fallback to the CPU).  gene_G: [n_g, S] int8 blocks on the host.
    Returns float64 [n_g, n_g] numpy in the same order.  wgts None: pooled
    CalCor (jepeg); else the CalWgtCov-based correlation (jepegmix)."""
    S = gene_G[0].shape[1] if gene_G else 0
    bounds = _stat_bounds(pop_sizes, wgts)
    out: List[Optional[np.ndarray]] = [None] * len(gene_G)
    for npad, batch in _buckets([g.shape[0] for g in gene_G], S,
                                max_batch_elems):
        # rows padded to a multiple of 16 bytes, as the kernel reads them
        Gb = np.zeros((len(batch), npad, -(-S // 16) * 16), dtype=np.int8)
        for bi, gi in enumerate(batch):
            Gb[bi, :gene_G[gi].shape[0], :S] = gene_G[gi]
        with full_f32_matmul():
            partials = gene_stats.gene_partials(
                torch.from_numpy(Gb).to(device), bounds)
        R = gene_stats.gene_corr(*partials, pop_sizes, wgts).cpu().numpy()
        for bi, gi in enumerate(batch):
            n = gene_G[gi].shape[0]
            out[gi] = R[bi, :n, :n]
    return out


def _bucket_rows(buckets, gene_idx) -> np.ndarray:
    """Panel row ids of every bucket, one after the other: bucket by
    bucket, gene by gene, each gene padded to its bucket's npad rows with
    K2's -1 sentinel.  Per-gene row arrays laid out alike (see
    gene_stats_resident) line up with it."""
    ids = np.full(sum(npad * len(b) for npad, b in buckets), -1,
                  dtype=np.int32)
    o = 0
    for npad, batch in buckets:
        for gi in batch:
            ids[o:o + len(gene_idx[gi])] = gene_idx[gi]
            o += npad
    return ids


def _gather_genes(G_dev, idx_dev, B, npad):
    """K2 gather of one bucket's gene rows: int8 [B, npad, S_dev]."""
    return gather_rows(G_dev, idx_dev).reshape(B, npad, G_dev.shape[1])


def _group_rows(buckets, gene_idx, n_groups: int):
    """Each window group's share of every bucket: per group, its
    (npad, gene ids) per bucket -- the bucket's genes split into
    n_groups consecutive blocks of ceil(B / n_groups) slots, a slot past
    the bucket's genes left empty (None: all rows -1, weights 0)."""
    out = [[] for _ in range(n_groups)]
    for npad, batch in buckets:
        Bg = -(-len(batch) // n_groups)
        for g in range(n_groups):
            part = batch[g * Bg:(g + 1) * Bg]
            out[g].append((npad, part + [None] * (Bg - len(part))))
    return out


def gene_stats_resident(
    G_dev,
    gene_idx: List[np.ndarray],
    Ws: List[np.ndarray],              # per gene [6, n_g] float64
    zs: List[np.ndarray],              # per gene [n_g] float64
    pop_sizes: Sequence[int],
    wgts: Optional[Sequence[float]] = None,
    lam: float = 0.1,
    max_batch_elems: int = 1 << 26,
    local_pop_sizes: Optional[Sequence[int]] = None,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Per-gene category statistics (CovU [6, 6], WWt [6, 6], U [6],
    float64) with every O(n^2) step on G_dev's device: K2 gathers each
    bucket's gene rows from the resident panel G_dev (int8 [R, S_dev],
    its first sum(pop_sizes) columns the selected populations), exact
    per-population partials, the float64 CorG with the 1 + lambda ridge
    diagonal (src/gene.cpp:569-586), then U = W z, CovU = W CorG W^T and
    WWt = W W^T (src/gene.cpp:594-648): per bucket one K2 gather and one
    ``gene_partials`` per subject shard, one ``gene_stats_tail``
    (``ops/gene_stats``).  The host keeps only the k <= 6 pruning and
    chi-square (src/jepegmix.cpp:122-139).

    With a mesh, G_dev is one tuple of subject-shard panels per window
    group (parallel/mesh.shard_columns order, local population widths
    ``local_pop_sizes``, zero columns at the end): each bucket's genes
    are split over the window groups (the last slots of a group may be
    empty), every shard gathers its rows (K2) and takes its partials,
    and their sum -- exact integers, so the same for any shard count --
    goes through the float64 tail once on the group's lead device.

    Each group's ids, W and z go to its devices in one copy each before
    the first launch, and its results come back in one copy after the
    last."""
    if not gene_idx:
        return []
    if isinstance(G_dev, torch.Tensor):
        groups = [(G_dev,)]
        bounds = _stat_bounds(pop_sizes, wgts)
        S_all = int(G_dev.shape[1])
    else:
        groups = [tuple(g) for g in G_dev]
        bounds = _stat_bounds(local_pop_sizes, wgts)
        S_all = -(-sum(int(m) for m in pop_sizes) // 16) * 16
    buckets = _buckets([len(g) for g in gene_idx], S_all, max_batch_elems)
    res: List[Optional[Tuple]] = [None] * len(gene_idx)
    for panels, gbuckets in zip(groups, _group_rows(buckets, gene_idx,
                                                    len(groups))):
        lead = panels[0].device
        ids = np.full(sum(npad * len(b) for npad, b in gbuckets), -1,
                      dtype=np.int32)
        # W^T and z in the same row layout (zero on pad rows and slots)
        Wz = np.zeros((len(ids), 7))
        o = 0
        for npad, batch in gbuckets:
            for gi in batch:
                if gi is not None:
                    n = len(gene_idx[gi])
                    ids[o:o + n] = gene_idx[gi]
                    Wz[o:o + n, :6] = np.asarray(Ws[gi]).T
                    Wz[o:o + n, 6] = zs[gi]
                o += npad
        ids_dev = {}
        for p in panels:
            if p.device not in ids_dev:
                ids_dev[p.device] = torch.from_numpy(ids).to(p.device)
        Wz = torch.from_numpy(Wz).to(lead)
        outs = []
        o = 0
        for npad, batch in gbuckets:
            B = len(batch)
            if B == 0:
                continue
            partials = None
            for p in panels:
                idx = ids_dev[p.device].narrow(0, o, B * npad)
                with full_f32_matmul():  # the f32 partials: exact integers
                    part = gene_stats.gene_partials(
                        _gather_genes(p, idx, B, npad), bounds)
                partials = part if partials is None else tuple(
                    a + b.to(lead) for a, b in zip(partials, part))
            outs.append(gene_stats.gene_stats_tail(
                *partials, pop_sizes, wgts,
                ids_dev[lead].narrow(0, o, B * npad),
                Wz.narrow(0, o, B * npad), lam))
            o += B * npad
        if not outs:
            continue
        CovU, WWt, U = (torch.cat(x).cpu().numpy() for x in zip(*outs))
        for j, gi in enumerate(gi for _, batch in gbuckets for gi in batch):
            if gi is not None:
                res[gi] = (CovU[j], WWt[j], U[j])
    return res


def gene_corr_resident(
    G_dev: torch.Tensor,
    gene_idx: List[np.ndarray],
    pop_sizes: Sequence[int],
    wgts: Optional[Sequence[float]] = None,
    max_batch_elems: int = 1 << 26,
) -> List[np.ndarray]:
    """Correlation matrix per gene (float64 [n_g, n_g], input order),
    gene rows gathered by K2 on G_dev's device, one gather and one batched
    product per power-of-two bucket (the decode-once design of SURVEY.md
    section 7; the reference reloads the panel per call,
    src/jepegmix.cpp:65-91)."""
    if not gene_idx:
        return []
    bounds = _stat_bounds(pop_sizes, wgts)
    buckets = _buckets([len(g) for g in gene_idx], int(G_dev.shape[1]),
                       max_batch_elems)
    ids = torch.from_numpy(_bucket_rows(buckets, gene_idx)).to(G_dev.device)
    mats = []
    o = 0
    for npad, batch in buckets:
        B = len(batch)
        Gb = _gather_genes(G_dev, ids.narrow(0, o, B * npad), B, npad)
        o += B * npad
        with full_f32_matmul():
            partials = gene_stats.gene_partials(Gb, bounds)
        mats.append(gene_stats.gene_corr(*partials, pop_sizes, wgts))
    out: List[Optional[np.ndarray]] = [None] * len(gene_idx)
    for (npad, batch), R in zip(buckets, mats):
        R = R.cpu().numpy()
        for bi, gi in enumerate(batch):
            n = len(gene_idx[gi])
            out[gi] = R[bi, :n, :n]
    return out

"""The gene path's kernels (gauss_tpu_torch.ops.gene_stats,
csrc/gene_stats.cu) against gauss_tpu's gene statistics, on seeded numpy
inputs at small sizes.

On the CPU the wrappers run their plain versions: the partials against
an int64 numpy Gram (exact), the float64 combine against gauss_tpu's
``_corr_from_pop_partials`` and the whole bucket (gather, partials,
combine, mask, ridge, W contractions) against gauss_tpu's jitted
``_gene_stats_unsharded``, at rtol 1e-10 / atol 1e-12: both sides take
the same exact integer partials and combine them in float64 in the same
population order; the W contractions sum in another order.  Fake CUDA
tensors (FakeTensorMode) show that a CUDA tensor reaches the kernel
library and never a plain version, and how often each entry point of
core/genekernels launches each kernel.  The `gpu` tests hold each kernel
against its plain version on the card: partials and CorG bit-equal,
CovU / WWt / U within rtol 1e-12 / atol 1e-13 normwise (the kernel sums
the contractions in another order), at bucket sizes 8 to 512, segment
edges at every offset of a warp's step, segments shorter than a 16-byte
piece or empty, one long segment split over a block's warps, and buckets
whose gene count is not a multiple of the tail's genes a block.  The
host's grouping of segments into partials blocks and the tail's layout
are tested on the CPU.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.core import genekernels as j_gk
from gauss_tpu_torch.core import genekernels as t_gk
from gauss_tpu_torch.core.stats import full_f32_matmul, segment_bounds
from gauss_tpu_torch.ops import _build, gather, gene_stats
from gauss_tpu_torch.utils.benchdata import POPS_33KG

RTOL, ATOL = 1e-10, 1e-12            # against gauss_tpu (float64 combine)
GPU_RTOL, GPU_ATOL = 1e-12, 1e-13    # kernel against plain, normwise
LAM = 0.1
# segments whose bounds are not multiples of 4 (~200 columns in all); P =
# 29 holds widths of 2 to 5 columns beside wider ones.  "narrow": 29
# segments of 1 to 5 columns, for the partials (a population of one makes
# every weighted correlation NaN: m / (m - 1))
SIZES = {1: (203,), 3: (37, 61, 103),
         29: (2, 3, 4, 5, 9, 6, 7, 11, 3, 13, 5, 2, 9, 10, 7, 2, 6, 8, 11,
              4, 13, 5, 9, 7, 3, 6, 11, 2, 5),
         "narrow": tuple(1 + k % 5 for k in range(29))}


def _panel(sizes, R=40, seed=0):
    """int8 dosages [R, S] (S = sum(sizes) padded with zero columns to a
    multiple of 16); row 0 is monomorphic, its correlations NaN."""
    rng = np.random.default_rng(seed)
    S = sum(sizes)
    G = np.zeros((R, -(-S // 16) * 16), dtype=np.int8)
    G[:, :S] = rng.integers(0, 3, size=(R, S))
    G[0, :S] = 1
    return G


def _bucket(G, B, npad, seed=1, nan_row=True, empty_slot=True):
    """A bucket of B genes: ids [B npad] (-1 on pad rows; the last slot
    empty when ``empty_slot``), Wz [B npad, 7] (W^T, z; zero on pad rows),
    and per gene its real rows, W [6, n] and z."""
    rng = np.random.default_rng(seed)
    ids = np.full(B * npad, -1, dtype=np.int32)
    Wz = np.zeros((B * npad, 7))
    genes = []
    for b in range(B):
        if empty_slot and b == B - 1 and B > 1:
            genes.append(None)
            continue
        n = int(rng.integers(max(2, npad // 2 + 1), npad + 1))
        rows = rng.choice(np.arange(1, G.shape[0]), n, replace=False)
        if nan_row and b == 0:
            rows[1] = 0                       # a real NaN row
        W = rng.normal(size=(6, n))
        z = rng.normal(size=n)
        ids[b * npad:b * npad + n] = rows
        Wz[b * npad:b * npad + n, :6] = W.T
        Wz[b * npad:b * npad + n, 6] = z
        genes.append((rows.astype(np.int32), W, z))
    return ids, Wz, genes


def _partials(G, ids, B, npad, bounds, device="cpu"):
    Gt = torch.from_numpy(G).to(device)
    idx = torch.from_numpy(ids).to(device)
    Gb = gather.gather_rows(Gt, idx).reshape(B, npad, G.shape[1])
    with full_f32_matmul():
        return Gb, gene_stats.gene_partials(Gb, bounds)


def _bounds(sizes, weighted):
    return t_gk._stat_bounds(sizes, _wgts(sizes) if weighted else None)


def _wgts(sizes):
    w = np.arange(1, len(sizes) + 1, dtype=np.float64)
    return tuple(float(x) for x in w / w.sum())


CASES = [(P, B, npad) for P in (1, 3, 29) for B, npad in ((1, 8), (5, 16))]
CASE_IDS = [f"P{P}-B{B}-n{n}" for P, B, n in CASES]
NARROW = [("narrow", 1, 8), ("narrow", 5, 16)]


@pytest.mark.parametrize("P,B,npad", CASES + NARROW,
                         ids=CASE_IDS + ["narrow-B1-n8", "narrow-B5-n16"])
def test_partials_plain_exact(P, B, npad):
    """C, S, Q of every segment equal an int64 numpy Gram of the gathered
    rows (pad rows zero), columns past the last segment never read."""
    sizes = SIZES[P]
    G = _panel(sizes)
    G[:, sum(sizes):] = 7                     # never read
    ids, _, _ = _bucket(G, B, npad)
    bounds = segment_bounds(sizes)
    _, (C, S, Q) = _partials(G, ids, B, npad, bounds)
    X = np.where(ids[:, None] >= 0, G[np.maximum(ids, 0)], 0).astype(
        np.int64).reshape(B, npad, -1)
    P = len(sizes)
    assert C.shape == (P, B, npad, npad) and C.dtype == torch.float32
    for k in range(P):
        Xk = X[:, :, bounds[k]:bounds[k + 1]]
        np.testing.assert_array_equal(C[k].numpy(),
                                      Xk @ Xk.transpose(0, 2, 1))
        np.testing.assert_array_equal(S[k].numpy(), Xk.sum(axis=2))
        np.testing.assert_array_equal(Q[k].numpy(), (Xk * Xk).sum(axis=2))


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["pooled", "weighted"])
@pytest.mark.parametrize("P,B,npad", CASES, ids=CASE_IDS)
def test_corr_plain_matches_gauss_tpu(P, B, npad, weighted):
    """gene_corr (its plain version here) against gauss_tpu's
    _corr_from_pop_partials on the same partials, NaN rows included."""
    sizes = SIZES[P]
    G = _panel(sizes)
    ids, _, _ = _bucket(G, B, npad)
    wgts = _wgts(sizes) if weighted else None
    _, part = _partials(G, ids, B, npad, _bounds(sizes, weighted))
    got = gene_stats.gene_corr(*part, sizes, wgts).numpy()
    ref = np.asarray(j_gk._corr_from_pop_partials(
        *(jnp.asarray(p.numpy()) for p in part), sizes, wgts))
    assert got.shape == (B, npad, npad) and np.isnan(got[0]).any()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["pooled", "weighted"])
@pytest.mark.parametrize("P,B,npad", CASES, ids=CASE_IDS)
def test_stats_plain_matches_gauss_tpu(P, B, npad, weighted):
    """The whole bucket: K2's gather, gene_partials and gene_stats_tail
    (plain versions) against gauss_tpu's _gene_stats_unsharded on the same
    genes: a real NaN row (its gene's CovU NaN), pad rows (no NaN leaks),
    an empty slot (CovU the ridge's W W^T, here 0)."""
    sizes = SIZES[P]
    G = _panel(sizes)
    ids, Wz, genes = _bucket(G, B, npad)
    wgts = _wgts(sizes) if weighted else None
    _, part = _partials(G, ids, B, npad, _bounds(sizes, weighted))
    got = [x.numpy() for x in gene_stats.gene_stats_tail(
        *part, sizes, wgts, torch.from_numpy(ids), torch.from_numpy(Wz),
        LAM)]
    real = ids.reshape(B, npad) >= 0
    ref = j_gk._gene_stats_unsharded(
        jnp.asarray(G[:, :sum(sizes)]),
        jnp.asarray(np.maximum(ids, 0).reshape(B, npad)),
        jnp.asarray(Wz[:, :6].reshape(B, npad, 6).transpose(0, 2, 1)),
        jnp.asarray(Wz[:, 6].reshape(B, npad)),
        jnp.asarray(real.astype(np.float64)), pop_sizes=sizes, wgts=wgts,
        lam=LAM)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, np.asarray(r), rtol=RTOL, atol=ATOL)
    CovU, WWt, U = got
    assert np.isnan(CovU[0]).all()               # the real NaN row
    for b in range(1, B):
        assert np.isfinite(CovU[b]).all() and np.isfinite(U[b]).all()
    if B > 1:                                    # the empty slot
        assert not CovU[-1].any() and not WWt[-1].any() and not U[-1].any()


def test_gene_corr_matrices_pads_rows_to_16():
    """The per-call path pads each block's rows to a multiple of 16 bytes
    for the kernel; the correlations equal gauss_tpu's for a row width
    that is not one (203 columns)."""
    sizes = SIZES[3]
    G = _panel(sizes)[:, :sum(sizes)]
    blocks = [G[[1, 2, 3]], G[4:15], G[[0, 5, 6, 7]]]
    for wgts in (None, _wgts(sizes)):
        got = t_gk.gene_corr_matrices(blocks, sizes, wgts, device="cpu")
        ref = j_gk.gene_corr_matrices(blocks, sizes, wgts)
        for a, r in zip(got, ref):
            np.testing.assert_allclose(a, r, rtol=RTOL, atol=ATOL)


# ------------------------------------------------------- launch choices

MIX = segment_bounds([s for _, s, _ in POPS_33KG])   # 64 to 6,360 columns


@pytest.mark.parametrize("bounds,n,S,B,starts,warps", [
    (MIX, 16, 33168, 126, [0, 4, 6, 7, 11, 12, 16, 22, 23, 28, 29], 4),
    (MIX, 8, 33168, 96, [0, 4, 6, 7, 11, 12, 16, 22, 23, 28, 29], 4),
    (MIX, 16, 33168, 20, [0, 4, 6, 7, 11, 12, 16, 22, 23, 28, 29], 8),
    (MIX, 64, 33168, 6, [0, 3, 4, 5, 6, 7, 11, 12, 13, 17, 18, 22, 23, 27,
                         28, 29], 8),                  # 128-byte steps
    (MIX, 256, 33168, 2, [0, 3, 4, 5, 6, 7, 11, 12, 13, 17, 18, 22, 23, 27,
                          28, 29], 4),                 # 36 tiles a gene
    ([0, 6360], 16, 6368, 184, [0, 1], 8),             # jepeg: one segment
    ([0, 6360], 512, 6368, 3, [0, 1], 8),
    (segment_bounds(SIZES["narrow"]), 8, 96, 5, [0, 16, 29], 8),
    (segment_bounds(SIZES["narrow"]), 32, 96, 5, [0, 8, 16, 24, 29], 4),
    ([0, 0, 3, 3], 16, 16, 5, [0, 3], 1),              # empty segments
    ([5, 700], 16, 704, 5, [0, 1], 2),                 # one step past 512
], ids=["mix-n16", "mix-n8", "mix-n16-B20", "mix-n64", "mix-n256",
        "jepeg-n16", "jepeg-n512", "narrow-n8", "narrow-n32", "empty",
        "unaligned"])
def test_partials_groups(bounds, n, S, B, starts, warps):
    """A partials block takes consecutive segments while their steps (a
    warp's 256 bytes a row at n <= 16, 128 above, from a segment's first
    16-byte piece to its last) stay within PARTIALS_GROUP_STEPS and they
    number at most 16 (8 at n >= 32), a longer segment alone; its warps
    give the longest group about two steps each, 1 to
    PARTIALS_MAX_WARPS, and 4 at most when more would fill the card's
    warps twice over."""
    got, w = gene_stats.partials_groups(bounds, n, S, B)
    assert (got, w) == (starts, warps)
    step = 256 if n <= 16 else 128
    b = np.asarray(bounds)
    steps = -(-(np.minimum((b[1:] + 15) // 16 * 16, S) - b[:-1] // 16 * 16)
              // step)
    for g0, g1 in zip(got, got[1:]):
        assert g0 < g1 and g1 - g0 <= (16 if n <= 16 else 8)
        assert g1 - g0 == 1 or steps[g0:g1].sum() <= \
            gene_stats.PARTIALS_GROUP_STEPS


@pytest.mark.parametrize("n", [8, 16, 32, 64, 128, 256, 512, 1024])
def test_tail_layout_fits(n):
    """The tail's layout at every population count: a block's genes fill
    its threads with pairs at n <= 16 (none idles) and take one gene or
    one 64 x 64 tile above; all P populations in one round while they fit
    (n <= 32 at POPS_33KG's 29 populations), else rounds within
    TAIL_ROUND_BYTES; the shared memory the kernel then asks for (a round's
    C, S, Q and row values, or the stats epilogue's R, W R and W W^T
    slices where larger, then W z and ids, 128-byte aligned) stays within
    its 200 KB."""
    up = lambda x: -(-x // 128) * 128
    for P in range(1, gene_stats.MAX_POPS + 1):
        ts, tiles, genes, stages = gene_stats.tail_layout(n, P)
        assert ts == min(n, 64) and tiles == (n // ts) ** 2
        pairs = genes * ts * ts
        if n <= 16:
            assert pairs == gene_stats.TAIL_THREADS
        else:
            assert genes == 1
        rows = genes * ts if tiles == 1 else 2 * ts
        stage = 4 * (pairs + 2 * rows) + 40 * rows
        assert 1 <= stages <= P
        assert stages * stage <= gene_stats.TAIL_ROUND_BYTES
        if stages < P:
            assert (stages + 1) * stage > gene_stats.TAIL_ROUND_BYTES
        if n <= 32 and P <= 29:
            assert stages == P
        ring = (up(4 * stages * pairs) + 2 * up(4 * stages * rows)
                + 40 * stages * rows)
        epi = 8 * (pairs + genes * 6 * ts + gene_stats.TAIL_THREADS)
        smem = up(max(ring, epi)) + up(56 * rows) + 4 * rows + 128
        assert smem <= 200 * 1024


# --------------------------------------------------------------- fake CUDA

def _fake_mode():
    fake = pytest.importorskip("torch._subclasses.fake_tensor")
    try:
        mode = fake.FakeTensorMode()
        with mode:
            torch.empty(1, device=torch.device("cuda", 0))
    except Exception as e:           # no fake CUDA device in this build
        pytest.skip(f"cannot make a fake CUDA tensor here: {e}")
    return fake, mode


def _no_plain(monkeypatch):
    def plain(*a, **k):
        raise AssertionError("a CUDA tensor took the plain version")
    for name in ("gene_partials_plain", "gene_corr_plain",
                 "gene_stats_tail_plain"):
        monkeypatch.setattr(gene_stats, name, plain)
    monkeypatch.setattr(gather, "gather_rows_plain", plain)


def test_cuda_tensors_never_fall_back(monkeypatch):
    """Each wrapper given CUDA tensors goes to the kernel library (here
    one that refuses) and never to its plain version; tensors on another
    non-CPU device raise."""
    _, mode = _fake_mode()
    _no_plain(monkeypatch)

    def refuse():
        raise RuntimeError("no kernel library here")
    monkeypatch.setattr(_build, "library", refuse)
    bounds = segment_bounds(SIZES[3])

    def calls(d):
        Gb = torch.empty((2, 8, 208), dtype=torch.int8, device=d)
        C = torch.empty((3, 2, 8, 8), device=d)
        S = torch.empty((3, 2, 8), device=d)
        ids = torch.empty(16, dtype=torch.int32, device=d)
        Wz = torch.empty((16, 7), dtype=torch.float64, device=d)
        yield lambda: gene_stats.gene_partials(Gb, bounds)
        yield lambda: gene_stats.gene_corr(C, S, S, SIZES[3], None)
        yield lambda: gene_stats.gene_stats_tail(C, S, S, SIZES[3],
                                                 _wgts(SIZES[3]), ids, Wz,
                                                 LAM)

    with mode:
        for call in calls(torch.device("cuda", 0)):
            with pytest.raises(RuntimeError, match="no kernel library"):
                call()
    for call in calls("meta"):
        with pytest.raises(ValueError, match="unsupported device"):
            call()


class _RecordingLib:
    """Stands in for the kernel library: records each launch, succeeds."""

    def __init__(self):
        self.calls = []

    def gauss_gather_rows(self, *a):
        self.calls.append(("gather_rows",))
        return 0

    def gauss_gene_partials(self, X, S, B, n, P, bounds, *rest):
        self.calls.append(("gene_partials", B, n, P, list(bounds)[:P + 1]))
        return 0

    def gauss_gene_tail(self, C, S, Q, P, B, n, pooled, *rest):
        self.calls.append(("gene_stats_tail", B, n, P, rest[-2]))
        return 0


def _fake_card(monkeypatch, fake):
    """The recording library, a no-op device context and stream, and
    host copies of fake results that read zeros."""
    lib = _RecordingLib()
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    np_dtype = {torch.float64: np.float64, torch.float32: np.float32}
    monkeypatch.setattr(
        fake.FakeTensor, "numpy",
        lambda self: np.zeros(tuple(self.shape), dtype=np_dtype[self.dtype]),
        raising=False)
    return lib


@pytest.mark.filterwarnings("ignore:Accessing the data pointer")
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["pooled", "weighted"])
def test_entry_points_launch_per_bucket(monkeypatch, weighted):
    """With CUDA tensors, gene_stats_resident (one device and a 2 x 2
    mesh), gene_corr_resident and gene_corr_matrices launch K2 and
    gene_partials once per bucket and subject shard, gene_stats_tail
    (gene_corr's kernel) once per bucket and window group, and never a
    plain version; the launch counts tell the tail's two modes apart."""
    fake, mode = _fake_mode()
    _no_plain(monkeypatch)
    lib = _fake_card(monkeypatch, fake)
    monkeypatch.setattr(gene_stats, "launches",
                        dict.fromkeys(gene_stats.launches, 0))

    def counted(partials, tail, corr):
        assert gene_stats.launches == {"gene_partials": partials,
                                       "gene_stats_tail": tail,
                                       "gene_corr": corr}
        lib.calls.clear()
        gene_stats.launches.update(dict.fromkeys(gene_stats.launches, 0))
    sizes = SIZES[3]
    wgts = _wgts(sizes) if weighted else None
    P = 3 if weighted else 1
    rng = np.random.default_rng(5)
    gene_idx = [rng.choice(40, n, replace=False).astype(np.int32)
                for n in (3, 5, 12, 9, 20, 2, 30)]      # buckets 8, 16, 32
    Ws = [rng.normal(size=(6, len(g))) for g in gene_idx]
    zs = [rng.normal(size=len(g)) for g in gene_idx]
    n_buckets = 3
    cuda = torch.device("cuda", 0)
    kinds = lambda: [c[0] for c in lib.calls]
    with mode:
        panel = torch.empty((40, 208), dtype=torch.int8, device=cuda)
        out = t_gk.gene_stats_resident(panel, gene_idx, Ws, zs, sizes, wgts,
                                       lam=LAM)
        assert len(out) == len(gene_idx)
        assert kinds().count("gather_rows") == n_buckets
        assert kinds().count("gene_partials") == n_buckets
        tails = [c for c in lib.calls if c[0] == "gene_stats_tail"]
        assert len(tails) == n_buckets and all(c[4] == 1 for c in tails)
        assert sorted(c[2] for c in tails) == [8, 16, 32]
        assert all(c[3] == P for c in lib.calls if c[0] != "gather_rows")
        counted(n_buckets, n_buckets, 0)

        # a 2 x 2 mesh: two window groups of two subject shards each
        local = tuple(-(-m // 2) for m in sizes)
        shards = [tuple(torch.empty((40, 112), dtype=torch.int8,
                                    device=cuda) for _ in range(2))
                  for _ in range(2)]
        t_gk.gene_stats_resident(shards, gene_idx, Ws, zs, sizes, wgts,
                                 lam=LAM, local_pop_sizes=local)
        assert kinds().count("gather_rows") == 2 * 2 * n_buckets
        assert kinds().count("gene_partials") == 2 * 2 * n_buckets
        assert kinds().count("gene_stats_tail") == 2 * n_buckets
        counted(2 * 2 * n_buckets, 2 * n_buckets, 0)

        mats = t_gk.gene_corr_resident(panel, gene_idx, sizes, wgts)
        assert [m.shape for m in mats] == [(len(g), len(g))
                                           for g in gene_idx]
        tails = [c for c in lib.calls if c[0] == "gene_stats_tail"]
        assert kinds().count("gene_partials") == n_buckets
        assert len(tails) == n_buckets and all(c[4] == 0 for c in tails)
        counted(n_buckets, 0, n_buckets)

        blocks = [np.zeros((len(g), sum(sizes)), dtype=np.int8)
                  for g in gene_idx]
        t_gk.gene_corr_matrices(blocks, sizes, wgts, device=cuda)
        assert kinds().count("gene_partials") == n_buckets
        assert kinds().count("gene_stats_tail") == n_buckets
        assert "gather_rows" not in kinds()
        counted(n_buckets, 0, n_buckets)


# --------------------------------------------------------------- the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _same_bits(a, b):
    """NaN in the same places and the same bits everywhere else."""
    nan = torch.isnan(b)
    return bool(torch.equal(torch.isnan(a), nan)
                and torch.equal(a[~nan].view(torch.int64),
                                b[~nan].view(torch.int64)))


def _normwise(a, b):
    """max |a - b| over max |b| (+ atol), on b's finite entries, and
    whether the non-finite entries agree."""
    fin = torch.isfinite(b)
    same = bool(torch.equal(torch.isfinite(a), fin))
    if not fin.any():
        return same, 0.0, 0.0
    return same, float((a - b)[fin].abs().max()), float(b[fin].abs().max())


GPU_SHAPES = [(1, 5, 8), (29, 5, 8), (29, 5, 16), (29, 3, 32), (1, 3, 64),
              (29, 3, 64), (29, 2, 128), (3, 2, 512), (29, 1, 512)]


@pytest.mark.gpu
@pytest.mark.parametrize("npad", [8, 16, 32, 64])
def test_partials_kernel_narrow_segments_on_gpu(npad):
    """Segments of 1 to 5 columns (every 16-byte piece straddles several)
    and POPS_33KG-like widths (~1,100 columns): the kernel's partials
    equal the plain version's."""
    dev = _card()
    rng = np.random.default_rng(npad)
    for sizes in (SIZES["narrow"],
                  tuple(int(x) for x in rng.integers(900, 1400, 29))):
        G = _panel(sizes, R=200, seed=npad)
        ids, _, _ = _bucket(G, 5, npad, seed=npad)
        bounds = segment_bounds(sizes)
        Gb, part = _partials(G, ids, 5, npad, bounds, device=dev)
        with full_f32_matmul():
            plain = gene_stats.gene_partials_plain(Gb, bounds)
        for a, b in zip(part, plain):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["pooled", "weighted"])
@pytest.mark.parametrize("P,B,npad", GPU_SHAPES,
                         ids=[f"P{p}-B{b}-n{n}" for p, b, n in GPU_SHAPES])
def test_kernels_match_plain_on_gpu(P, B, npad, weighted):
    """Partials and CorG bit-equal to the plain versions on the card;
    CovU, WWt and U within rtol 1e-12 / atol 1e-13 normwise; the TF32
    switch moves nothing."""
    dev = _card()
    rng = np.random.default_rng(npad + P)
    sizes = tuple(int(x) for x in rng.integers(2, 1200 // P + 3, P))
    G = _panel(sizes, R=max(600, 2 * npad), seed=npad)
    ids, Wz, _ = _bucket(G, B, npad, seed=P)
    wgts = _wgts(sizes) if weighted else None
    bounds = _bounds(sizes, weighted)
    Gb, part = _partials(G, ids, B, npad, bounds, device=dev)
    with full_f32_matmul():
        plain = gene_stats.gene_partials_plain(Gb, bounds)
    for a, b in zip(part, plain):
        assert torch.equal(a, b)
    assert _same_bits(gene_stats.gene_corr(*part, sizes, wgts),
                      gene_stats.gene_corr_plain(*part, sizes, wgts))
    ids_d, Wz_d = torch.from_numpy(ids).to(dev), torch.from_numpy(Wz).to(dev)
    got = gene_stats.gene_stats_tail(*part, sizes, wgts, ids_d, Wz_d, LAM)
    ref = gene_stats.gene_stats_tail_plain(*part, sizes, wgts, ids_d, Wz_d,
                                           LAM)
    for a, r in zip(got, ref):
        same, d, scale = _normwise(a, r)
        assert same and d <= GPU_RTOL * scale + GPU_ATOL, (d, scale)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        again = gene_stats.gene_partials(Gb, bounds)
        tail = gene_stats.gene_stats_tail(*again, sizes, wgts, ids_d, Wz_d,
                                          LAM)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    for a, b in zip(again, part):
        assert torch.equal(a, b)
    for a, b in zip(tail, got):
        assert _same_bits(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("width", [255, 257])
@pytest.mark.parametrize("npad", [8, 16, 32])
def test_partials_kernel_segment_edges_on_gpu(npad, width):
    """64 segments of 255 or 257 columns from four starting columns: their
    edges fall at every offset modulo a warp's step (256 bytes a row at n
    <= 16, 128 above; every offset modulo 16 too); partials bit-equal."""
    dev = _card()
    for start in range(4):
        bounds = np.array([start + width * k for k in range(65)])
        S = -(-int(bounds[-1]) // 16) * 16
        G = _panel((S,), R=100, seed=start)
        G[:, int(bounds[-1]):] = 7               # never read
        ids, _, _ = _bucket(G, 3, npad, seed=start)
        Gb, part = _partials(G, ids, 3, npad, bounds, device=dev)
        with full_f32_matmul():
            plain = gene_stats.gene_partials_plain(Gb, bounds)
        for a, b in zip(part, plain):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("npad", [8, 16, 32, 64])
def test_partials_kernel_short_and_long_segments_on_gpu(npad):
    """Segments shorter than one 16-byte piece (and empty ones), one
    segment of 3 columns alone, and jepeg's one segment of 6,360 columns
    (split over a block's warps): partials bit-equal."""
    dev = _card()
    for bounds in ([0, 0, 3, 3, 10, 25, 26, 40, 41, 47, 48, 48, 63],
                   [5, 8], [0, 6360]):
        bounds = np.asarray(bounds)
        S = -(-(int(bounds[-1]) + 1) // 16) * 16
        G = _panel((S,), R=max(100, 2 * npad), seed=npad)
        ids, _, _ = _bucket(G, 5, npad, seed=npad)
        Gb, part = _partials(G, ids, 5, npad, bounds, device=dev)
        with full_f32_matmul():
            plain = gene_stats.gene_partials_plain(Gb, bounds)
        for a, b in zip(part, plain):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["pooled", "weighted"])
@pytest.mark.parametrize("npad", [8, 16])
def test_tail_kernel_partial_blocks_on_gpu(npad, weighted):
    """Buckets of 1 to 7 genes at n = 8 (4 genes a tail block) and 16,
    each with a real NaN row and an empty slot as _bucket makes them:
    CorG bit-equal, CovU / WWt / U within rtol 1e-12 / atol 1e-13
    normwise, the NaN gene's CovU NaN and the empty slot's zero."""
    dev = _card()
    sizes = SIZES[29]
    G = _panel(sizes, R=200, seed=npad)
    wgts = _wgts(sizes) if weighted else None
    bounds = _bounds(sizes, weighted)
    for B in range(1, 8):
        ids, Wz, _ = _bucket(G, B, npad, seed=B)
        _, part = _partials(G, ids, B, npad, bounds, device=dev)
        assert _same_bits(gene_stats.gene_corr(*part, sizes, wgts),
                          gene_stats.gene_corr_plain(*part, sizes, wgts))
        ids_d = torch.from_numpy(ids).to(dev)
        Wz_d = torch.from_numpy(Wz).to(dev)
        got = gene_stats.gene_stats_tail(*part, sizes, wgts, ids_d, Wz_d,
                                          LAM)
        ref = gene_stats.gene_stats_tail_plain(*part, sizes, wgts, ids_d,
                                               Wz_d, LAM)
        for a, r in zip(got, ref):
            same, d, scale = _normwise(a, r)
            assert same and d <= GPU_RTOL * scale + GPU_ATOL, (B, d, scale)
        assert torch.isnan(got[0][0]).all()
        if B > 1:
            assert not got[0][-1].any() and not got[2][-1].any()

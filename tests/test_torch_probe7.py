"""Probe 7's kernels (gauss_tpu_torch.probes.probe7_int4): the int4
format, K3's plain versions (on int8 and on packed operands, the latter
through the kernel's widening and order of K) against JAX's int4 product,
K4's plain version against JAX's row sums, the wrappers' argument checks,
and both CUDA kernels against their plain versions on a card.  Every
comparison is exact (integer results).

XLA's CPU backend refuses a dot_general of int4 operands with an int32
result type ("custom element sizes on non-sub-byte types"), so the JAX
side casts to jnp.int4 and then to int32 before the dot: the int4 cast,
which is what the port reproduces, stays in the comparison."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu_torch.probes import probe7_int4 as p7


def _jax_int4_dot(a8, b8):
    f = jax.jit(lambda x, y: jax.lax.dot_general(
        x.astype(jnp.int4).astype(jnp.int32),
        y.astype(jnp.int4).astype(jnp.int32), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32))
    return np.asarray(f(a8, b8))


def test_pack_unpack_round_trip_full_range():
    vals = np.arange(-8, 8, dtype=np.int8)
    for K in (16, 17, 1, 33):                     # odd K pads a nibble
        x = torch.from_numpy(np.resize(vals, (5, K)).astype(np.int8))
        p = p7.pack_int4(x)
        assert p.dtype == torch.uint8 and p.shape == (5, (K + 1) // 2)
        assert torch.equal(p7.unpack_int4(p, K), x)
    # element 2j in the low nibble of byte j, two's complement
    p = p7.pack_int4(torch.tensor([[-1, 2, 7, -8]], dtype=torch.int8))
    assert p.tolist() == [[0x2F, 0x87]]


def test_int4_cast_matches_jnp_int4_over_int8():
    x = np.arange(-128, 128, dtype=np.int8)[None, :]
    ref = np.asarray(jax.jit(
        lambda v: v.astype(jnp.int4).astype(jnp.int32))(x))
    got = p7.unpack_int4(p7.pack_int4(torch.from_numpy(x)), 256)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("lo, hi, seed", [(-2, 3, 0), (-8, 8, 1)])
def test_int4_dot_plain_matches_jax(lo, hi, seed):
    """The TPU probe's own check (default_rng(0), 256 x 2048 in [-2, 2])
    and values over all of int4's range."""
    rng = np.random.default_rng(seed)
    a8 = rng.integers(lo, hi, size=(256, 2048), dtype=np.int8)
    b8 = rng.integers(lo, hi, size=(256, 2048), dtype=np.int8)
    got = p7.int4_dot(torch.from_numpy(a8), torch.from_numpy(b8))
    assert got.dtype == torch.int32 and got.shape == (256, 256)
    np.testing.assert_array_equal(got.numpy(), _jax_int4_dot(a8, b8))
    np.testing.assert_array_equal(
        got.numpy(), a8.astype(np.int64) @ b8.astype(np.int64).T)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_resident_rowsum_plain_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 3, size=(12, p7.ROW), dtype=np.int8)
    cast = jnp.int4 if dtype == "int4" else jnp.int8
    ref = np.asarray(jax.jit(lambda v: jnp.sum(
        v.astype(cast).astype(jnp.int32), axis=1))(x))
    xt = torch.from_numpy(x)
    blk = xt if dtype == "int8" else p7.pack_int4(xt)
    got = p7.resident_rowsum(blk, dtype)
    assert got.dtype == torch.int32 and got.shape == (12, 128)
    np.testing.assert_array_equal(got.numpy(),
                                  np.broadcast_to(ref[:, None], (12, 128)))


def test_wrappers_check_and_cpu_path_does_not_count():
    before = dict(p7.launches)
    a = torch.zeros((3, 8), dtype=torch.int8)
    p7.int4_dot(a, a)
    p7.resident_rowsum(torch.zeros((2, 32), dtype=torch.int8))
    assert p7.launches == before
    with pytest.raises(TypeError):
        p7.int4_dot(a.float(), a)
    with pytest.raises(ValueError):
        p7.int4_dot(a, torch.zeros((3, 9), dtype=torch.int8))
    with pytest.raises(TypeError):          # an int4 block must be packed
        p7.resident_rowsum(torch.zeros((2, 32), dtype=torch.int8), "int4")
    with pytest.raises(ValueError):
        p7.resident_rowsum(torch.zeros((2, 32), dtype=torch.int8), "int2")


def _nibbles(p):
    """numpy uint8 [R, Kb] packed bytes -> int8 [R, 2 Kb] nibble values in
    0..15 (element 2j the low nibble of byte j), for JAX's int4 cast."""
    return np.stack([p & 15, p >> 4], axis=2).reshape(p.shape[0],
                                                      -1).astype(np.int8)


@pytest.mark.parametrize("M, N, Kb", [
    (7, 5, 17),              # a row of 17 bytes: off the 16-byte stride
    (130, 70, 150),          # off the 128 x 128 tile and the 128-byte box
    (1, 1, 1),
    (64, 129, 1025),
])
def test_int4_dot_packed_plain_matches_jax(M, N, Kb):
    """K3's product on packed operands (its CPU path multiplies the values
    as the kernel widens and orders them) against JAX's int4 product of
    the same nibbles; every byte value occurs."""
    rng = np.random.default_rng(M * N + Kb)
    pa = rng.integers(0, 256, size=(M, Kb), dtype=np.uint8)
    pb = rng.integers(0, 256, size=(N, Kb), dtype=np.uint8)
    got = p7._int4_dot_packed(torch.from_numpy(pa), torch.from_numpy(pb))
    assert got.dtype == torch.int32 and got.shape == (M, N)
    np.testing.assert_array_equal(got.numpy(),
                                  _jax_int4_dot(_nibbles(pa), _nibbles(pb)))


def _k3_order(n_boxes):
    """Value index of each widened position, from the kernel's comment:
    in a 128-byte box, byte 32 t + 4 s + i holds values 2 (32 t + 4 s + i)
    and + 1, widened to positions 32 s + 4 t + i (low nibble) and
    32 s + 16 + 4 t + i (high nibble)."""
    order = np.empty(256 * n_boxes, dtype=np.int64)
    for b in range(n_boxes):
        for t in range(4):
            for s in range(8):
                for i in range(4):
                    for h in range(2):
                        order[256 * b + 32 * s + 16 * h + 4 * t + i] = \
                            256 * b + 2 * (32 * t + 4 * s + i) + h
    return order


@pytest.mark.parametrize("Kb", [1, 128, 300])
def test_widen_int4_plain_is_unpack_in_the_kernel_order(Kb):
    """The widened values are unpack_int4's, permuted by the shared order
    of K (zeros past Kb), and a dot product of permuted rows equals the
    unpermuted one."""
    rng = np.random.default_rng(Kb)
    p = torch.from_numpy(rng.integers(0, 256, size=(6, Kb), dtype=np.uint8))
    p[0, :min(Kb, 256)] = torch.arange(min(Kb, 256), dtype=torch.uint8)
    n_boxes = -(-Kb // 128)
    wide = p7.widen_int4_plain(p)
    assert wide.dtype == torch.int8 and wide.shape == (6, 256 * n_boxes)
    vals = torch.zeros((6, 256 * n_boxes), dtype=torch.int8)
    vals[:, :2 * Kb] = p7.unpack_int4(p, 2 * Kb)
    order = torch.from_numpy(_k3_order(n_boxes))
    assert torch.equal(wide, vals[:, order])
    assert sorted(order.tolist()) == list(range(256 * n_boxes))
    w64, v64 = wide.to(torch.int64), vals.to(torch.int64)
    assert torch.equal(w64 @ w64.T, v64 @ v64.T)


def test_int4_dot_packed_checks_arguments():
    p = torch.zeros((3, 16), dtype=torch.uint8)
    with pytest.raises(TypeError):
        p7._int4_dot_packed(p.to(torch.int8), p)
    with pytest.raises(TypeError):
        p7._int4_dot_packed(p[0], p)
    with pytest.raises(ValueError):
        p7._int4_dot_packed(p, torch.zeros((3, 32), dtype=torch.uint8))
    assert p7.k3_width(1) == 16 and p7.k3_width(34176) == 17088
    assert p7.k3_width(33) == 32


@pytest.mark.parametrize("make, kw, exc", [
    (lambda: torch.zeros((2, 32), dtype=torch.int8), dict(cluster=0),
     ValueError),
    (lambda: torch.zeros((2, 32), dtype=torch.int8), dict(cluster=17),
     ValueError),
    (lambda: torch.zeros((2, 24), dtype=torch.int8), {}, ValueError),
    (lambda: torch.zeros((32, 2), dtype=torch.int8).T, {}, ValueError),
    (lambda: torch.zeros((0, 32), dtype=torch.int8), {}, ValueError),
    (lambda: torch.zeros(32, dtype=torch.int8), {}, TypeError),
    (lambda: torch.zeros((2, 32), dtype=torch.float32), {}, TypeError),
    (lambda: torch.zeros((2, 32), dtype=torch.uint8), dict(dtype="int8"),
     TypeError),
])
def test_resident_rowsum_checks_arguments(make, kw, exc):
    """K4's wrapper refuses on the CPU what the kernel would refuse on a
    card: clusters outside 1..16, rows that are not 16-byte multiples,
    non-contiguous or empty blocks, wrong shapes and types."""
    with pytest.raises(exc):
        p7.resident_rowsum(make(), **kw)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M, N, K", [
    (256, 256, 2048),        # the probe's shape
    (130, 70, 300),          # M, N, K all off the tile (128, 128) and the
                             # 256-value box; one N tile: the pair's
                             # second tile is empty
    (1, 1, 1),
    (300, 129, 2049),        # odd K: a half-filled last byte
    (1000, 257, 34176),      # the bench width
    (64, 64, 32),            # K below one box (16-byte rows)
    (130, 129, 4352),        # K a multiple of the 256-value box
    (257, 300, 1000),        # three N tiles: the second pair half empty
    (128, 256, 256),         # on every tile and box edge
])
def test_int4_dot_kernel_matches_plain_on_gpu(M, N, K):
    dev = _cuda()
    rng = np.random.default_rng(M + N + K)
    a = torch.from_numpy(rng.integers(-8, 8, (M, K), dtype=np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(-8, 8, (N, K), dtype=np.int8)).to(dev)
    before = p7.launches["int4_dot"]
    got = p7.int4_dot(a, b)
    assert p7.launches["int4_dot"] == before + 1
    assert torch.equal(got, p7.int4_dot_plain(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("va, vb", [(-8, -8), (7, -8)])
def test_int4_dot_kernel_at_int4_ends_on_gpu(va, vb):
    """Every product at one end of int4's range, at the bench width."""
    dev = _cuda()
    a = torch.full((130, 34176), va, dtype=torch.int8, device=dev)
    b = torch.full((200, 34176), vb, dtype=torch.int8, device=dev)
    assert bool((p7.int4_dot(a, b) == va * vb * 34176).all())


@pytest.mark.gpu
@pytest.mark.parametrize("Kb", [16, 80, 17088])
def test_int4_dot_packed_kernel_matches_plain_on_gpu(Kb):
    """K3's product on packed operands of every byte value, rows of 16
    bytes up to the bench width's, against its plain version."""
    dev = _cuda()
    rng = np.random.default_rng(Kb)
    pa = torch.from_numpy(rng.integers(0, 256, (200, Kb), dtype=np.uint8))
    pb = torch.from_numpy(rng.integers(0, 256, (300, Kb), dtype=np.uint8))
    got = p7._int4_dot_packed(pa.to(dev), pb.to(dev))
    assert torch.equal(got.cpu(), p7._int4_dot_packed(pa, pb))


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_resident_rowsum_kernel_matches_plain_on_gpu(dtype, cluster):
    """Every size that fits in one cluster, from one row up, including
    sizes that leave some CTAs of the cluster without rows."""
    dev = _cuda()
    rng = np.random.default_rng(cluster)
    x = torch.from_numpy(rng.integers(-128, 128, (160, p7.ROW),
                                      dtype=np.int8)).to(dev)
    blk = x if dtype == "int8" else p7.pack_int4(x)
    k, _, n = p7.capacity(blk.shape[1], cluster)
    assert k >= 1 and n >= 1
    for R in range(1, min(k * cluster, blk.shape[0]) + 1):
        got = p7.resident_rowsum(blk[:R], dtype, cluster)
        assert torch.equal(got, p7.resident_rowsum_plain(blk[:R], dtype)), R

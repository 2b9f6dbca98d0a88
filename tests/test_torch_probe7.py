"""Probe 7's kernels (gauss_tpu_torch.probes.probe7_int4): the int4
format, K3's plain version against JAX's int4 product, K4's plain version
against JAX's row sums, and both CUDA kernels against their plain
versions on a card.  Every comparison is exact (integer results).

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


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M, N, K", [
    (256, 256, 2048),        # the probe's shape
    (130, 70, 300),          # M, N, K all off the tile (128, 128, 128)
    (1, 1, 1),
    (300, 129, 2049),        # odd K: a half-filled last byte
    (1000, 257, 34176),      # the bench width
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
@pytest.mark.parametrize("cluster", [1, 2, 8])
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

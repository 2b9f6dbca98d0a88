"""K2 (gauss_tpu_torch.ops.gather): the plain version against
gauss_tpu.ops.dma_gather.take_rows (its jnp.take path on the CPU), the
padding sentinel as gauss_tpu's prepare_resident_panel applies it, and
the CUDA kernel against the plain version on a card.  All bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gauss_tpu.ops.dma_gather import take_rows
from gauss_tpu_torch.ops import gather


def _panel(seed, R=300, S=96):
    rng = np.random.default_rng(seed)
    return rng, rng.integers(-128, 128, (R, S), dtype=np.int8)


def test_plain_matches_take_rows():
    rng, G = _panel(0)
    idx = rng.integers(0, G.shape[0], 500).astype(np.int32)
    ref = np.asarray(take_rows(jnp.asarray(G), jnp.asarray(idx)))
    got = gather.gather_rows_plain(torch.from_numpy(G), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_sentinel_rows_are_zero_like_prepare_resident_panel():
    """gauss_tpu folds the sentinel in after the gather:
    take_rows(G, max(rows, 0)) * (rows >= 0)."""
    rng, G = _panel(1)
    idx = rng.integers(0, G.shape[0], 400).astype(np.int32)
    idx[rng.random(400) < 0.3] = -1
    real = (idx >= 0).astype(np.int8)
    ref = np.asarray(take_rows(jnp.asarray(G),
                               jnp.asarray(np.maximum(idx, 0)))) \
        * real[:, None]
    got = gather.gather_rows(torch.from_numpy(G), torch.from_numpy(idx))
    assert got.dtype == torch.int8 and got.shape == (400, G.shape[1])
    np.testing.assert_array_equal(got.numpy(), ref)
    assert not got[torch.from_numpy(idx) < 0].any()


def test_wrapper_checks_and_cpu_path_does_not_count():
    G = torch.zeros((4, 32), dtype=torch.int8)
    idx = torch.zeros(3, dtype=torch.int32)
    before = gather.launches
    assert gather.gather_rows(G, idx).shape == (3, 32)
    assert gather.launches == before
    with pytest.raises(TypeError):
        gather.gather_rows(G.float(), idx)
    with pytest.raises(TypeError):
        gather.gather_rows(G, idx.long())


@pytest.mark.gpu
@pytest.mark.parametrize("R, S, N", [
    (2000, 34176, 5000),     # bench-width rows: three 11,392 B pieces each
    (300, 96, 700),          # rows narrower than one piece
    (500, 12304, 900),       # two unequal pieces per row
    (50, 34176, 3),          # fewer pieces than CTAs
])
def test_kernel_matches_plain_on_gpu(R, S, N):
    """Bit-equal to the plain version, sentinels (-1) and ids >= R giving
    zero rows, in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng, G = _panel(2, R=R, S=S)
    idx = rng.integers(-1, R + 2, N).astype(np.int32)
    Gd, idxd = torch.from_numpy(G).to(dev), torch.from_numpy(idx).to(dev)
    before = gather.launches
    got = gather.gather_rows(Gd, idxd)
    assert gather.launches == before + 1
    ref = gather.gather_rows_plain(Gd, idxd.where(idxd < R, -1))
    assert torch.equal(got, ref)

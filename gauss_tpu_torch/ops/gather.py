"""K2: panel row gather ``out[i] = G[idx[i]]``, negative indices giving
zero rows (the padding sentinel of ``prepare_resident_panel``).

The kernel is ``csrc/gather.cu`` (replacing the Pallas TPU kernel
``gauss_tpu/ops/dma_gather.py:gather_rows``): bulk asynchronous row copies
through shared memory, taken in the order of their source rows so that a
row named twice is read from HBM once.  ``gather_rows`` runs it for CUDA
tensors and ``gather_rows_plain``, its plain PyTorch twin, for CPU
tensors only.
"""

from __future__ import annotations

import torch

from . import _build

#: kernel launches since the count was last set to 0 (CUDA path only)
launches = 0


def gather_rows_plain(G: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gather: int8 G [R, S], int32 idx [N]
    -> int8 [N, S]."""
    out = G.index_select(0, idx.clamp(min=0))
    return out * (idx >= 0)[:, None].to(G.dtype)


def _check(G: torch.Tensor, idx: torch.Tensor) -> None:
    if G.dtype != torch.int8 or G.dim() != 2:
        raise TypeError(f"G must be a 2-D int8 tensor, got {G.dtype} "
                        f"{tuple(G.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError(f"idx must be a 1-D int32 tensor, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if idx.device != G.device:
        raise ValueError(f"G on {G.device} but idx on {idx.device}")


def gather_rows(G: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[i] = G[idx[i]]`` for ``idx[i] >= 0``, a zero row otherwise.

    G: int8 [R, S] with S % 16 == 0 on CUDA; idx: int32 [N] on G's
    device.  Returns a new int8 [N, S] tensor.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global launches
    _check(G, idx)
    if G.device.type == "cpu":
        return gather_rows_plain(G, idx)
    if G.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {G.device}")
    R, S = G.shape
    if S % 16:
        raise ValueError(f"row width {S} is not a multiple of 16 bytes")
    if not (G.is_contiguous() and idx.is_contiguous()):
        raise ValueError("gather_rows needs contiguous G and idx")
    if G.data_ptr() % 16:
        raise ValueError("G must be 16-byte aligned")
    N = idx.shape[0]
    out = torch.empty((N, S), dtype=torch.int8, device=G.device)
    if N == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(G.device):
        order = torch.argsort(idx)          # output rows by source row
        err = lib.gauss_gather_rows(
            G.data_ptr(), idx.data_ptr(), order.data_ptr(), out.data_ptr(),
            N, S, R, torch.cuda.current_stream(G.device).cuda_stream)
    _build.check(err, "gather_rows")
    launches += 1
    return out

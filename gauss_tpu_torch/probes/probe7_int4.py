"""Probe 7 on Hopper: (a) does an int4 product run on this card, exactly?
(b) how large can a block held whole in on-chip memory be?

    python -m gauss_tpu_torch.probes.probe7_int4

The two kernels are ``csrc/probe7_int4.cu``, replacing the two Pallas
TPU kernels of ``probes/probe7_int4.py``:

* K3 ``int4_dot(a, b)`` (replaces ``g``): exact int32 ``a @ b.T`` of two
  int8 matrices cast to int4, read as packed nibbles (``pack_int4``; the
  packing pass is a kernel the wrapper launches) and multiplied with
  ``mma.sync m16n8k64 s4`` -- Hopper's ``wgmma`` takes no 4-bit operand.
* K4 ``resident_rowsum(x, dtype, cluster)`` (replaces ``h``): int32 row
  sums broadcast to 128 columns, over a block staged whole in the shared
  memory of one cluster of ``cluster`` CTAs; each CTA sums the rows its
  neighbour holds, through distributed shared memory.  ``capacity`` asks
  the card (occupancy queries, no launch) how many rows fit.

CUDA tensors launch the kernels, CPU tensors take the plain versions
(``int4_dot_plain``, ``resident_rowsum_plain``), any other device raises.
The int4 format: two's-complement nibbles, element 2j in the low nibble of
byte j.  Casting an int8 to int4 keeps its low nibble (127 -> -1), as
``jnp.int4`` does.
"""

from __future__ import annotations

import ctypes
import sys
from typing import Dict, Tuple

import numpy as np
import torch

from ..ops import _build

#: kernel launches since the counts were last set to 0 (CUDA path only)
launches: Dict[str, int] = {"int4_dot": 0, "resident_rowsum": 0}

#: the probe's row width: 42 K tiles of 1024 subject columns
ROW = 43008
#: bytes per packed row that K3 reads: a multiple of its 64-byte K step
_K3_ROW_BYTES = 64


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def _as_int4(x: torch.Tensor) -> torch.Tensor:
    """int8 -> the int4 value of its low nibble, as int16."""
    v = (x & 15).to(torch.int16)
    return torch.where(v >= 8, v - 16, v)


def _device_kind(*ts: torch.Tensor) -> str:
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError(f"tensors on {[str(t.device) for t in ts]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type


def _check_int8_2d(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.int8 or x.dim() != 2:
        raise TypeError(f"{name} must be a 2-D int8 tensor, got {x.dtype} "
                        f"{tuple(x.shape)}")


def _pack_plain(x: torch.Tensor, width: int) -> torch.Tensor:
    """Plain packing of int8 [R, K] into uint8 [R, width] nibbles."""
    R, K = x.shape
    v = torch.zeros((R, 2 * width), dtype=torch.uint8, device=x.device)
    v[:, :K] = (x & 15).to(torch.uint8)
    return v[:, 0::2] | (v[:, 1::2] << 4)


def _pack(x: torch.Tensor, width: int) -> torch.Tensor:
    """Pack int8 [R, K] into uint8 [R, width] (width % 4 == 0 on CUDA),
    zero nibbles past K."""
    if x.device.type == "cpu":
        return _pack_plain(x, width)
    if not x.is_contiguous():
        raise ValueError("pack_int4 needs a contiguous tensor")
    R, K = x.shape
    out = torch.empty((R, width), dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().gauss_pack_int4(
            x.data_ptr(), out.data_ptr(), R, K, width,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "pack_int4")
    return out


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """int8 [R, K] -> uint8 [R, ceil(K / 2)] of int4 nibbles (the low
    nibble of each value; element 2j in the low nibble of byte j)."""
    _check_int8_2d("x", x)
    _device_kind(x)
    nb = -(-x.shape[1] // 2)
    if x.device.type == "cpu":
        return _pack_plain(x, nb)
    out = _pack(x, _ceil_to(nb, 4))
    return out if out.shape[1] == nb else out[:, :nb].contiguous()


def unpack_int4(p: torch.Tensor, K: int) -> torch.Tensor:
    """uint8 [R, >= ceil(K / 2)] nibbles -> int8 [R, K] int4 values."""
    if p.dtype != torch.uint8 or p.dim() != 2 or 2 * p.shape[1] < K:
        raise TypeError(f"p must be a 2-D uint8 tensor of at least "
                        f"{-(-K // 2)} columns, got {p.dtype} "
                        f"{tuple(p.shape)}")
    v = torch.stack([p & 15, p >> 4], dim=2).reshape(p.shape[0], -1)[:, :K]
    v = v.to(torch.int8)
    return torch.where(v >= 8, v - 16, v)


# ---------------------------------------------------------------- K3

def int4_dot_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of the int4 casts of int8 a [M, K] and
    b [N, K]: int64 on the CPU; on a card float32 with TF32 off (exact
    while 64 K < 2^24: every partial sum is an integer below it) and
    float64 beyond."""
    A, B = _as_int4(a), _as_int4(b)
    if a.device.type == "cpu":
        return (A.to(torch.int64) @ B.to(torch.int64).T).to(torch.int32)
    ft = torch.float32 if 64 * a.shape[1] < 2 ** 24 else torch.float64
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (A.to(ft) @ B.to(ft).T).to(torch.int32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def int4_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 [M, N] = int4(a) @ int4(b).T for int8 a [M, K], b [N, K],
    exact.  On a card both operands are packed (K padded to a multiple of
    128 nibbles) and multiplied by the s4 mma kernel."""
    _check_int8_2d("a", a)
    _check_int8_2d("b", b)
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"K differs: {tuple(a.shape)} vs {tuple(b.shape)}")
    if _device_kind(a, b) == "cpu":
        return int4_dot_plain(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("int4_dot needs contiguous operands")
    (M, K), N = a.shape, b.shape[0]
    width = _ceil_to(max(-(-K // 2), 1), _K3_ROW_BYTES)
    pa, pb = _pack(a, width), _pack(b, width)
    out = torch.empty((M, N), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = _build.library().gauss_int4_dot(
            pa.data_ptr(), pb.data_ptr(), out.data_ptr(), M, N, width,
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "int4_dot")
    launches["int4_dot"] += 1
    return out


# ---------------------------------------------------------------- K4

def _rowsum_check(x: torch.Tensor, dtype: str) -> None:
    want = {"int8": torch.int8, "int4": torch.uint8}.get(dtype)
    if want is None:
        raise ValueError(f"dtype must be 'int8' or 'int4', got {dtype!r}")
    if x.dtype != want or x.dim() != 2:
        raise TypeError(f"a {dtype} block is a 2-D {want} tensor"
                        f"{' (pack_int4)' if dtype == 'int4' else ''}, got "
                        f"{x.dtype} {tuple(x.shape)}")


def resident_rowsum_plain(x: torch.Tensor, dtype: str = "int8"
                          ) -> torch.Tensor:
    """int32 [R, 128]: each row's sum broadcast across 128 columns.
    ``x``: int8 [R, S], or for dtype "int4" the packed uint8 [R, S / 2]."""
    _rowsum_check(x, dtype)
    v = x if dtype == "int8" else unpack_int4(x, 2 * x.shape[1])
    s = v.to(torch.int32).sum(dim=1, dtype=torch.int32)
    return s[:, None].expand(-1, 128).contiguous()


def resident_rowsum(x: torch.Tensor, dtype: str = "int8",
                    cluster: int = 1) -> torch.Tensor:
    """resident_rowsum_plain's result, computed on a card by one cluster
    of ``cluster`` CTAs (1..16) that holds the whole block in shared
    memory; raises if the block does not fit (see ``capacity``).
    Rows are 16-byte multiples: S % 16 == 0 (S / 2 for int4)."""
    _rowsum_check(x, dtype)
    if _device_kind(x) == "cpu":
        return resident_rowsum_plain(x, dtype)
    if not 1 <= cluster <= 16:
        raise ValueError(f"cluster must be 1..16, got {cluster}")
    R, row_bytes = x.shape
    if row_bytes % 16 or not x.is_contiguous():
        raise ValueError(f"rows of {row_bytes} bytes: need a contiguous "
                         f"block with 16-byte multiple rows")
    out = torch.empty((R, 128), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _build.library().gauss_resident_rowsum(
            x.data_ptr(), out.data_ptr(), R, row_bytes,
            int(dtype == "int4"), cluster,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, f"resident_rowsum ({R} rows of {row_bytes} B over "
                      f"{cluster} CTAs)")
    launches["resident_rowsum"] += 1
    return out


def capacity(row_bytes: int, cluster: int) -> Tuple[int, int, int]:
    """(rows per CTA, opt-in shared memory per CTA in bytes, clusters the
    card holds at once) for the largest K4 block of ``row_bytes`` rows
    that fits in clusters of ``cluster`` CTAs on the current card: the
    opt-in limit bounds the rows, cudaOccupancyMaxActiveClusters must
    then find room for at least one cluster.  (0, limit, 0) if none."""
    lib = _build.library()
    optin, n = ctypes.c_int(), ctypes.c_int()
    _build.check(lib.gauss_resident_rowsum_fit(row_bytes, 1, cluster,
                                               ctypes.byref(optin),
                                               ctypes.byref(n)),
                 "resident_rowsum_fit")
    k = (optin.value - lib.gauss_resident_rowsum_smem(row_bytes, 0)) \
        // row_bytes
    while k > 0:
        _build.check(lib.gauss_resident_rowsum_fit(row_bytes, k, cluster,
                                                   ctypes.byref(optin),
                                                   ctypes.byref(n)),
                     "resident_rowsum_fit")
        if n.value > 0:
            return k, optin.value, n.value
        k -= 1
    return 0, optin.value, 0


def main() -> int:
    if not torch.cuda.is_available():
        print("probe7: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"probe7 on {torch.cuda.get_device_name(0)}", flush=True)

    # (a) the TPU probe's own int4 check: 256 x 2048 in [-2, 2], seed 0
    rng = np.random.default_rng(0)
    a8 = rng.integers(-2, 3, size=(256, 2048), dtype=np.int8)
    b8 = rng.integers(-2, 3, size=(256, 2048), dtype=np.int8)
    want = torch.from_numpy(a8.astype(np.int64) @ b8.astype(np.int64).T)
    got = int4_dot(torch.from_numpy(a8).to(dev), torch.from_numpy(b8).to(dev))
    ok = bool(torch.equal(got.cpu().to(torch.int64), want))
    print(f"int4 dot (mma.sync m16n8k64 s4) 256 x 2048: exact={ok}",
          flush=True)

    # (b) the largest resident block per dtype and cluster size, each size
    # up to it checked exactly against the plain version
    x = torch.from_numpy(rng.integers(0, 3, size=(160, ROW),
                                      dtype=np.int8)).to(dev)
    blocks = {"int8": x, "int4": pack_int4(x)}
    for dt, blk in blocks.items():
        row_bytes = blk.shape[1]
        for c in (1, 8, 16):
            k, optin, n = capacity(row_bytes, c)
            R = min(k * c, blk.shape[0])
            print(f"resident {dt} [R, {ROW}] ({row_bytes} B/row), cluster "
                  f"{c}: {k} rows/CTA = {k * row_bytes / 1024:.1f} KiB of "
                  f"{optin / 1024:.1f} KiB; {k * c} rows = "
                  f"{k * c * row_bytes / 1024:.1f} KiB per cluster; {n} "
                  f"such clusters at once", flush=True)
            bad = [r for r in range(1, R + 1)
                   if not torch.equal(resident_rowsum(blk[:r], dt, c),
                                      resident_rowsum_plain(blk[:r], dt))]
            print(f"  sizes 1..{R} rows exact: {not bad}"
                  f"{'' if not bad else f' (wrong at {bad[:5]})'}",
                  flush=True)
            ok &= not bad
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

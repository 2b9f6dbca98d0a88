"""Device meshes for windowed analyses: a (window x subject) grid of
torch devices that one process drives.

The reference has no parallelism (single-threaded C++ loops; SURVEY.md
section 2.3); this is gauss_tpu's mesh design (its parallel/mesh.py)
on the port's resident kernels.  Two mesh axes:

* ``window``: prediction windows are independent given the panel
  (src/dist.cpp:129-141), so window group i (the devices of mesh row i)
  takes a contiguous block of a region's windows and runs it alone;
* ``subject``: every statistic is a sum over subjects, so the panel is
  split by columns into ``n_subject`` shards, each holding an equal slice
  of EVERY population segment (``subject_shard_layout``).  Shard j lives
  on device [i, j] of every window group i.  A group's preparation adds
  its shards' exact int32 row sums, K1 runs once per shard, and the f32
  partials of the Gram are added on the group's lead device [i, 0] in
  shard order (``ops/window_kernel``), where the rest of the window's
  work runs once.  Zero-padded subject columns add exactly zero.

No genotype byte moves between devices: the cross-device traffic is the
row sums, the Gram partials and the outputs, all plain device-to-device
copies in a fixed order, so no collective library is needed.  A device
may appear more than once: one card then holds several shards (the CPU
tests and the one-card chip check build their meshes that way).  A mesh
never falls back to the CPU: its devices are the caller's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import stats
from ..ops.gram import K_CHUNK, ROW_TILE
from ..ops.window_kernel import (WindowKernelSpec, build_resident_ld_corr,
                                 build_resident_qcat_kernel,
                                 build_resident_region_kernel,
                                 full_f32_matmul, pack_tri_i16,
                                 pad_pop_segments, prepare_sharded_panel,
                                 win_slab)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A (window x subject) grid of torch devices: ``devices[i, j]`` holds
    subject shard j of window group i."""

    devices: np.ndarray                       # [n_window, n_subject] object
    axis_names: Tuple[str, str] = ("window", "subject")

    @property
    def shape(self) -> Dict[str, int]:
        return {"window": int(self.devices.shape[0]),
                "subject": int(self.devices.shape[1])}

    def groups(self) -> List[Tuple[torch.device, ...]]:
        """Each window group's devices, shard by shard (the first is the
        group's lead)."""
        return [tuple(row) for row in self.devices]

    def distinct(self) -> List[torch.device]:
        """The mesh's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices.ravel().tolist()))


def _normalize(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_window: int, n_subject: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over the first n_window * n_subject of ``devices`` (default:
    the CUDA devices), row-major.  An explicit list may repeat a device.
    Raises when there are too few devices or they mix device types."""
    need = int(n_window) * int(n_subject)
    if need < 1:
        raise ValueError(f"mesh {n_window}x{n_subject} has no device")
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_normalize(d) for d in devices]
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    devices = devices[:need]
    types = {d.type for d in devices}
    if len(types) > 1:
        raise ValueError(f"a mesh cannot mix device types {sorted(types)}")
    if not types <= {"cpu", "cuda"}:
        raise ValueError(f"unsupported device type {types.pop()}")
    arr = np.empty(need, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(int(n_window), int(n_subject)))


def subject_shard_layout(G: np.ndarray, pop_sizes: Sequence[int],
                         n_shards: int
                         ) -> Tuple[np.ndarray, Tuple[int, ...],
                                    Tuple[int, ...]]:
    """Reorder + pad the subject axis so a contiguous split into
    ``n_shards`` gives every shard an equal slice of every population.

    Returns (G_layout, padded_pop_sizes_global, local_pop_sizes).
    Shard s's block is [for each pop k: segment_k[s*loc_k:(s+1)*loc_k]]."""
    Gp, padded = pad_pop_segments(G, pop_sizes, multiple=n_shards)
    bounds = stats.segment_bounds(padded)
    locs = tuple(p // n_shards for p in padded)
    blocks = []
    for s in range(n_shards):
        for k in range(len(padded)):
            st = int(bounds[k]) + s * locs[k]
            blocks.append(Gp[..., st:st + locs[k]])
    return np.concatenate(blocks, axis=-1), padded, locs


def subject_valid_layout(pop_sizes: Sequence[int],
                         n_shards: int) -> np.ndarray:
    """Per-column validity mask [S_layout] matching subject_shard_layout:
    1 for real subjects, 0 for divisibility padding (which lands in the
    tail shards of each population segment)."""
    ones = np.ones((1, int(sum(pop_sizes))), dtype=np.float32)
    v, _, _ = subject_shard_layout(ones, pop_sizes, n_shards)
    return v[0]


def subject_valid_counts(pop_sizes: Sequence[int], n_shards: int
                         ) -> Tuple[Tuple[int, ...], ...]:
    """Per shard, the valid columns of each of its population segments
    (subject_valid_layout's ones, which lead each segment)."""
    out = []
    for s in range(n_shards):
        row = []
        for m in pop_sizes:
            loc = -(-int(m) // n_shards)
            row.append(max(0, min(loc, int(m) - s * loc)))
        out.append(tuple(row))
    return tuple(out)


def shard_columns(G: np.ndarray, pop_sizes: Sequence[int], n_shards: int,
                  multiple: int = K_CHUNK
                  ) -> Tuple[List[np.ndarray], Tuple[int, ...],
                             Tuple[int, ...]]:
    """Host column blocks of the subject shards: shard j's slice of every
    population (subject_shard_layout), each local segment zero-padded to
    ``multiple`` columns (K1's K_CHUNK).  Returns (blocks, local sizes,
    local padded widths)."""
    G_l, _, locs = subject_shard_layout(G, pop_sizes, n_shards)
    w = int(sum(locs))
    blocks, widths = [], tuple(locs)
    for j in range(n_shards):
        blk = G_l[:, j * w:(j + 1) * w]
        if multiple > 1:
            blk, widths = pad_pop_segments(blk, locs, multiple=multiple)
        blocks.append(np.require(blk, dtype=np.int8,
                                 requirements=["C", "W"]))
    return blocks, locs, widths


def place_shards(blocks: Sequence[np.ndarray], mesh: Mesh
                 ) -> List[Tuple[torch.Tensor, ...]]:
    """Each window group's shard panels: block j uploaded to device
    [i, j] of every group, once per distinct (shard, device)."""
    placed = {}
    out = []
    for devs in mesh.groups():
        row = []
        for j, d in enumerate(devs):
            if (j, d) not in placed:
                placed[(j, d)] = torch.from_numpy(blocks[j]).to(d)
            row.append(placed[(j, d)])
        out.append(tuple(row))
    return out


def sharded_spec(pop_sizes: Sequence[int], wgts, n_subject: int,
                 multiple: int = K_CHUNK, **kw) -> WindowKernelSpec:
    """The kernel spec of shard_columns' panels: the TRUE global sizes,
    the local segment widths, and each shard's valid counts."""
    locs = [-(-int(m) // n_subject) for m in pop_sizes]
    return WindowKernelSpec(
        pop_sizes=tuple(int(m) for m in pop_sizes),
        pop_sizes_padded=tuple(-(-x // multiple) * multiple for x in locs),
        wgts=None if wgts is None else tuple(float(x) for x in wgts),
        shard_valid=subject_valid_counts(pop_sizes, n_subject), **kw)


def group_width(W: int, n_window: int) -> int:
    """Windows each window group runs: its share of W rounded up to a
    slab multiple (win_slab).  The padding windows are fully masked,
    which is legal: B11 becomes (1 + lambda) I."""
    w = max(1, -(-int(W) // int(n_window)))
    return -(-w // win_slab(w)) * win_slab(w)


def upload_rows(rows: np.ndarray, devs: Sequence[torch.device]
                ) -> Tuple[torch.Tensor, ...]:
    """int32 row ids on each device of a group, one copy per distinct
    device."""
    by = {}
    for d in devs:
        if d not in by:
            by[d] = torch.from_numpy(np.ascontiguousarray(
                rows, dtype=np.int32)).to(d)
    return tuple(by[d] for d in devs)


def prepare_group(panels: Sequence[torch.Tensor], rows: np.ndarray,
                  spec: WindowKernelSpec):
    """prepare_sharded_panel for one window group: (X, Sp, Mu, V) with X
    the shifted shards (a tuple, or the tensor itself for one shard) and
    the statistics on the group's lead device."""
    Xs, Sp, Mu, V = prepare_sharded_panel(
        panels, upload_rows(rows, [p.device for p in panels]), None, spec)
    return (Xs[0] if len(Xs) == 1 else Xs), Sp, Mu, V


def _round_up(x: int, m: int) -> int:
    return -(-int(x) // m) * m


def _port_spec(spec, n_sub: int) -> WindowKernelSpec:
    """gauss_tpu's mesh spec (TRUE sizes, LOCAL unpadded widths) as the
    port's sharded spec."""
    return sharded_spec(spec.pop_sizes, spec.wgts, n_sub, lam=spec.lam,
                        min_abs_eig=spec.min_abs_eig,
                        eig_cutoff=spec.eig_cutoff)


def _panels(G_layout: np.ndarray, spec, mesh: Mesh):
    """Upload a panel in subject_shard_layout order (local widths
    spec.pop_sizes_padded, as gauss_tpu's mesh kernels take it) as
    K_CHUNK-padded shards."""
    n_sub = mesh.shape["subject"]
    w = int(sum(spec.pop_sizes_padded))
    if G_layout.shape[-1] != n_sub * w:
        raise ValueError(f"panel has {G_layout.shape[-1]} columns, the "
                         f"layout {n_sub} x {w}")
    blocks = []
    for j in range(n_sub):
        blk, _ = pad_pop_segments(np.asarray(G_layout)[:, j * w:(j + 1) * w],
                                  spec.pop_sizes_padded, multiple=K_CHUNK)
        blocks.append(np.require(blk, dtype=np.int8,
                                 requirements=["C", "W"]))
    return place_shards(blocks, mesh)


def _aligned(idx, mask, Wl: int, Wg: int, n: int) -> np.ndarray:
    """[Wg * n] row ids of the aligned layout: window w's rows at w * n,
    -1 where masked or padding."""
    out = np.full((Wg, n), -1, dtype=np.int32)
    out[:Wl, :idx.shape[1]] = np.where(np.asarray(mask) > 0,
                                       np.asarray(idx), -1)
    return out.ravel()


def _pad2(a, Wg: int, n: int) -> np.ndarray:
    out = np.zeros((Wg, n), dtype=np.float32)
    a = np.asarray(a, dtype=np.float32)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _window_groups(kind: str, spec, mesh: Mesh):
    """(G_layout, m_idx, u_idx, Z1, m_mask, u_mask) -> one output per
    window group: the W windows split into contiguous groups (W must
    divide by the window axis), each run as aligned bands of the resident
    kernel ``kind`` on its group's shards."""
    n_win, n_sub = mesh.shape["window"], mesh.shape["subject"]
    sspec = _port_spec(spec, n_sub)

    def run(G_layout, m_idx, u_idx, Z1, m_mask, u_mask):
        W = int(m_idx.shape[0])
        if W % n_win:
            raise ValueError(f"{W} windows do not split over {n_win} "
                             f"window groups")
        panels = _panels(G_layout, spec, mesh)
        Wl = W // n_win
        Wg = group_width(Wl, 1)
        Mp = _round_up(max(m_idx.shape[1], 1), ROW_TILE)
        Up = _round_up(max(u_idx.shape[1], 1), ROW_TILE) if u_idx is not None \
            else 0
        build = {"impute": build_resident_region_kernel,
                 "qcat": build_resident_qcat_kernel}
        fn = (build_resident_ld_corr(sspec, Mp) if kind == "ld"
              else build[kind](sspec, Mp, Up))
        outs = []
        for i, devs in enumerate(mesh.groups()):
            sl = slice(i * Wl, (i + 1) * Wl)
            lead = devs[0]
            Xm, Spm, Mum, _ = prepare_group(
                panels[i], _aligned(m_idx[sl], m_mask[sl], Wl, Wg, Mp), sspec)
            m_t0 = torch.arange(Wg, dtype=torch.int32, device=lead) * Mp
            mm = torch.from_numpy(_pad2(m_mask[sl], Wg, Mp)).to(lead)
            if kind == "ld":
                outs.append(fn(Xm, Spm, Mum, m_t0, mm)[:Wl].cpu())
                continue
            Xu, Spu, Muu, Vu = prepare_group(
                panels[i], _aligned(u_idx[sl], u_mask[sl], Wl, Wg, Up), sspec)
            u_t0 = torch.arange(Wg, dtype=torch.int32, device=lead) * Up
            um = torch.from_numpy(_pad2(u_mask[sl], Wg, Up)).to(lead)
            z1 = torch.from_numpy(_pad2(Z1[sl], Wg, Mp)).to(lead)
            out = fn(Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0, z1, mm, um)
            outs.append((out[:, :Wl] if kind == "impute" else out[:Wl]).cpu())
        return outs, Mp, Up

    return run


def build_sharded_region_kernel(spec, mesh: Mesh):
    """Sharded region imputation over a (window x subject) mesh, on the
    port's resident kernel.

    Contract (gauss_tpu's): ``spec.pop_sizes`` are the TRUE subject
    counts, ``spec.pop_sizes_padded`` the per-shard (LOCAL) segment
    widths from ``subject_shard_layout``; the panel's subject axis is in
    subject_shard_layout order, and W divides by the window-axis size.
    Returns (G_layout [R, S_layout] int8, m_idx [W, Mp] int32, u_idx
    [W, Up] int32, Z1, m_mask, u_mask) -> (z [W, Up], info [W, Up])
    float32 numpy."""
    run = _window_groups("impute", spec, mesh)

    def fn(G_layout, m_idx, u_idx, Z1, m_mask, u_mask):
        outs, _, _ = run(G_layout, m_idx, u_idx, Z1, m_mask, u_mask)
        Up = u_idx.shape[1]
        out = torch.cat(outs, dim=1)[:, :, :Up].numpy()
        return out[0], out[1]

    return fn


def build_sharded_qcat_region_kernel(spec, mesh: Mesh):
    """Sharded qcat tests (same contract as build_sharded_region_kernel).
    Returns (G_layout, m_idx [W, Mp], u_idx [W, Up], Z1, m_mask, u_mask)
    -> (t_m, chi_m, t_u, chi_u, num_eig) float32 numpy."""
    run = _window_groups("qcat", spec, mesh)

    def fn(G_layout, m_idx, u_idx, Z1, m_mask, u_mask):
        outs, Mp, Up = run(G_layout, m_idx, u_idx, Z1, m_mask, u_mask)
        raw = torch.cat(outs).numpy()
        M0, U0 = m_idx.shape[1], u_idx.shape[1]
        return (raw[:, :M0], raw[:, Mp:Mp + M0],
                raw[:, 2 * Mp:2 * Mp + U0],
                raw[:, 2 * Mp + Up:2 * Mp + Up + U0], raw[:, -1])

    return fn


def build_sharded_ld_kernel(spec, mesh: Mesh, fetch: str = "f32"):
    """Sharded computeLD over a batch of windows (same contract).
    Returns (G_layout, m_idx [W, Mp], m_mask [W, Mp]) -> corr [W, Mp, Mp]
    float32 ("f32") or the packed int16 lower triangle [W, Mp*(Mp+1)//2]
    ("i16tri"), numpy."""
    if fetch not in ("f32", "i16tri"):
        raise ValueError(f"fetch must be 'f32' or 'i16tri', got {fetch!r}")
    run = _window_groups("ld", spec, mesh)

    def fn(G_layout, m_idx, m_mask):
        outs, _, _ = run(G_layout, m_idx, None, None, m_mask, None)
        M0 = m_idx.shape[1]
        corr = torch.cat(outs)[:, :M0, :M0]
        return (pack_tri_i16(corr) if fetch == "i16tri" else corr).numpy()

    return fn


def build_sharded_pair_stats(local_pop_sizes: Sequence[int], mesh: Mesh):
    """Per-population pair sufficient statistics of an AIM panel over a
    (window x subject) mesh -- the compute core of mesh-parallel
    prep_zmix5 / zmix (reference: the serial all-pairs per-string CalCor
    loop, src/zmix.cpp:157-174 via src/util.cpp:153-169).

    Contract: the panel's subject axis is in ``subject_shard_layout``
    order with per-shard segment widths ``local_pop_sizes``; the SNP row
    axis is zero-padded to a multiple of the window-axis size.  Window
    group i takes row block i of every Gram, against all rows; its
    shards' slices are added on its lead device.  Plain torch float32
    products: every statistic is an integer below 2^24, so the partials
    and their sum are EXACT, and the host float64 combine is
    bit-identical for any shard count.

    Returns (G_layout [Np, S_layout] int8) -> (C [P, Np, Np], S [Np, P],
    Q [Np, P]) exact-integer float32 numpy."""
    bounds = stats.segment_bounds(local_pop_sizes)
    w = int(bounds[-1])
    n_win = mesh.shape["window"]

    def fn(G_layout):
        G_layout = np.asarray(G_layout)
        Np = G_layout.shape[0]
        if Np % n_win:
            raise ValueError(f"{Np} rows do not split over {n_win} window "
                             f"groups")
        nloc = Np // n_win
        Cs, Ss, Qs = [], [], []
        for i, devs in enumerate(mesh.groups()):
            lead = devs[0]
            C = S = Q = None
            for j, d in enumerate(devs):
                cols = G_layout[:, j * w:(j + 1) * w]
                Xg = torch.from_numpy(np.ascontiguousarray(cols)).to(d)
                Xl = Xg[i * nloc:(i + 1) * nloc]
                parts = []
                with full_f32_matmul():
                    for k in range(len(local_pop_sizes)):
                        a = Xl[:, int(bounds[k]):int(bounds[k + 1])].float()
                        b = Xg[:, int(bounds[k]):int(bounds[k + 1])].float()
                        parts.append((a @ b.T, a.sum(dim=1),
                                      (a * a).sum(dim=1)))
                Cj = torch.stack([p[0] for p in parts]).to(lead)
                Sj = torch.stack([p[1] for p in parts], dim=1).to(lead)
                Qj = torch.stack([p[2] for p in parts], dim=1).to(lead)
                C, S, Q = ((Cj, Sj, Qj) if C is None
                           else (C + Cj, S + Sj, Q + Qj))
            Cs.append(C.cpu())
            Ss.append(S.cpu())
            Qs.append(Q.cpu())
        return (torch.cat(Cs, dim=1).numpy(), torch.cat(Ss).numpy(),
                torch.cat(Qs).numpy())

    return fn


def _mesh_spec(true_pop_sizes, local_pop_sizes, wgts, lam, min_abs_eig):
    return WindowKernelSpec(
        pop_sizes=tuple(int(x) for x in true_pop_sizes),
        pop_sizes_padded=tuple(int(x) for x in local_pop_sizes),
        wgts=tuple(float(x) for x in wgts) if wgts is not None else None,
        lam=lam, min_abs_eig=min_abs_eig)


def sharded_region_impute(
    mesh: Mesh,
    G_layout: np.ndarray,      # [R, S_layout] int8, subject-shard layout
    m_idx: np.ndarray,         # [W, Mp] int32 panel-row indices
    u_idx: np.ndarray,         # [W, Up]
    Z1: np.ndarray,            # [W, Mp]
    m_mask: np.ndarray,
    u_mask: np.ndarray,
    true_pop_sizes: Sequence[int],
    local_pop_sizes: Sequence[int],
    wgts: Optional[Sequence[float]],
    lam: float = 0.1,
    min_abs_eig: float = 1e-5,
):
    """One-shot convenience wrapper over build_sharded_region_kernel."""
    spec = _mesh_spec(true_pop_sizes, local_pop_sizes, wgts, lam,
                      min_abs_eig)
    return build_sharded_region_kernel(spec, mesh)(
        G_layout, m_idx, u_idx, Z1, m_mask, u_mask)


def sharded_window_impute(
    mesh: Mesh,
    Gm: np.ndarray,            # [W, Mp, S_layout] int8 (subject-shard layout)
    Gu: np.ndarray,            # [W, Up, S_layout]
    Z1: np.ndarray,            # [W, Mp]
    m_mask: np.ndarray,
    u_mask: np.ndarray,
    true_pop_sizes: Sequence[int],
    local_pop_sizes: Sequence[int],
    wgts: Optional[Sequence[float]],
    lam: float = 0.1,
    min_abs_eig: float = 1e-5,
):
    """Window imputation of gathered blocks over a (window, subject)
    mesh: the blocks become one panel whose window w holds rows [w*Mp,
    (w+1)*Mp) and [W*Mp + w*Up, ...), then sharded_region_impute.  W
    must divide by the window-axis size; the subject axis of Gm/Gu must
    already be in subject_shard_layout order."""
    W, Mp, S = Gm.shape
    Up = Gu.shape[1]
    panel = np.concatenate([np.asarray(Gm).reshape(W * Mp, S),
                            np.asarray(Gu).reshape(W * Up, S)])
    m_idx = np.arange(W * Mp, dtype=np.int32).reshape(W, Mp)
    u_idx = (W * Mp + np.arange(W * Up, dtype=np.int32)).reshape(W, Up)
    return sharded_region_impute(mesh, panel, m_idx, u_idx, Z1, m_mask,
                                 u_mask, true_pop_sizes, local_pop_sizes,
                                 wgts, lam, min_abs_eig)

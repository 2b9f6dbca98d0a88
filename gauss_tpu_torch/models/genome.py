"""Genome-scale windowed engine: imputation (dist/distmix), LD
(computeLD), causality tests (qcat/qcatmix), gene tests
(jepeg/jepegmix) and ancestry (afmix, cpw2, prep_zmix5, zmix).

The reference scales to a genome by calling each analysis once per
window, re-reading the panel every call (SURVEY.md section 2.3).  Here
the panel region is decoded once (PanelStore), the selected populations
are uploaded to the engine's device once, and a region's windows run as
one batch through a resident region kernel (``ops/window_kernel``: K2
row gathers at preparation, K1 Grams per slab of windows, f32 solves):
``impute_region``, ``ld_region`` / ``ld_window`` and ``qcat_region``.
Gene tests gather each bucket of genes with K2 from the panel on the
device (``prepare_genes`` -> ``PreparedGenes.jepeg_region``).
With a device mesh (``GenomeEngine(store, mesh=...)``, parallel/mesh.py)
every device path runs over its (window x subject) grid: the panel is
split into subject shards, each window group takes a contiguous block of
the windows (or genes), and every shard runs K2 and K1 on its columns.
A float64 path (``PreparedRun.impute_window``, and the per-call
``models/dist``, ``models/ld``, ``models/qcat``) reproduces the
reference arithmetic and is the parity anchor: its correlation blocks
run on the device it is given, its solves on the host.
"""

from __future__ import annotations

import dataclasses
import mmap
import os
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch
from torch.profiler import record_function

from ..config import DEFAULT_SETTINGS, PanelFiles, Settings
from ..core import genekernels, linalg, stats, variants
from ..io import readers
from ..io.panel import PanelReader, read_panel_index
from ..ops.gram import K_CHUNK, ROW_TILE
from ..ops.window_kernel import (LD_FETCH, WindowKernelSpec,
                                 build_resident_ld_kernel,
                                 build_resident_qcat_kernel,
                                 build_resident_region_kernel,
                                 full_f32_matmul, pad_pop_segments, win_slab)
from ..parallel.mesh import (group_width, place_shards, prepare_group,
                             shard_columns, sharded_spec)
from ..utils.special import pchisq_upper, pnorm_two_sided
from . import ancestry
from .jepeg import (_categ_arrays, _gene_runs, empty_gene_frame,
                    run_gene_tests_stats)

#: the function that builds each resident kernel, by the engine's name
_BUILDERS = {"impute": build_resident_region_kernel,
             "qcat": build_resident_qcat_kernel,
             "ld": build_resident_ld_kernel}


# ---------------------------------------------------------------------------
# PanelStore: one-shot decoded panel region
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PanelStore:
    """Columnar decoded panel (SURVEY.md section 7)."""

    index: pd.DataFrame            # rsid chr bp a1 a2 af1ref fpos
    G: np.ndarray                  # int8 [n_snps, S_all] all populations
    af: np.ndarray                 # float64 [n_snps, P]
    desc: readers.PopDesc

    @classmethod
    def from_bgzf(cls, panel: PanelFiles, chrom: int = 0,
                  start_bp: Optional[int] = None,
                  end_bp: Optional[int] = None) -> "PanelStore":
        desc = readers.read_pop_desc(panel.pop_desc_file)
        idx = read_panel_index(panel.index_file, chrom=chrom,
                               start_bp=start_bp, end_bp=end_bp)
        reader = PanelReader(panel.data_file, desc)
        dec = reader.decode_rows(idx["fpos"].to_numpy())
        return cls(index=idx, G=dec.G, af=dec.af, desc=desc)

    @classmethod
    def from_arrays(cls, index: pd.DataFrame, G: np.ndarray,
                    af: np.ndarray, desc: readers.PopDesc) -> "PanelStore":
        return cls(index=index, G=G, af=af, desc=desc)

    def save(self, dir_path: str) -> None:
        os.makedirs(dir_path, exist_ok=True)
        np.save(os.path.join(dir_path, "G.npy"), self.G)
        np.save(os.path.join(dir_path, "af.npy"), self.af)
        self.index.to_parquet(os.path.join(dir_path, "index.parquet"))
        with open(os.path.join(dir_path, "pop_desc.txt"), "w") as fh:
            fh.write("Population_Abbreviation\tN\tSuper_Population\n")
            for p, m, sp in zip(self.desc.pops, self.desc.sizes,
                                self.desc.sup_pops):
                fh.write(f"{p}\t{m}\t{sp}\n")

    @classmethod
    def load(cls, dir_path: str) -> "PanelStore":
        G = np.load(os.path.join(dir_path, "G.npy"), mmap_mode="r")
        af = np.load(os.path.join(dir_path, "af.npy"))
        index = pd.read_parquet(os.path.join(dir_path, "index.parquet"))
        desc = readers.read_pop_desc(os.path.join(dir_path, "pop_desc.txt"))
        return cls(index=index, G=np.asarray(G), af=af, desc=desc)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pad_cols(G: np.ndarray, multiple: int) -> np.ndarray:
    """G with zero columns appended up to a multiple of ``multiple`` (at
    least one), as a new C-contiguous int8 array."""
    S = G.shape[1]
    out = np.zeros((G.shape[0], _round_up(max(S, 1), multiple)),
                   dtype=np.int8)
    out[:, :S] = G
    return out


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array of a batch copied to ``device`` (pageable memory: on
    a card the copy waits for the work queued on the stream before it)."""
    return torch.from_numpy(a).to(device)


def _aligned_max_bytes(device: torch.device) -> int:
    """Largest aligned-layout batch (int8 band bytes) on ``device`` before
    the shared layout takes over.  GAUSS_ALIGNED_MAX_BYTES overrides.

    Rule: a third of the memory free on the device when the batch is
    built.  A new aligned batch is built before the previous one is
    evicted, so two can coexist; the last third is left for the region
    tail's [W, Mp, Mp] f32 temporaries.  On the CPU the same rule applies
    to the host's physical memory.  With a mesh the rule holds per
    device, for the bands of every shard it holds."""
    env = os.environ.get("GAUSS_ALIGNED_MAX_BYTES")
    if env:
        return int(env)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
    else:
        free = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return int(free) // 3


@dataclasses.dataclass
class WindowResult:
    table: pd.DataFrame            # output rows for the prediction window
    n_measured: int
    n_unmeasured: int


class GenomeEngine:
    """Windowed analyses over a PanelStore on one explicit device or
    device mesh."""

    def __init__(self, store: PanelStore, device=None,
                 settings: Settings = DEFAULT_SETTINGS,
                 device_linalg: bool = False, mesh=None):
        """``device``: where the panel and the region kernel live (a
        ``torch.device`` or its name); the engine never picks one.
        ``mesh``: instead of ``device``, a (window x subject) device mesh
        (parallel/mesh.make_mesh): the panel is split into subject shards,
        shard j on device [i, j] of every window group i, and each window
        group runs a contiguous block of a region's windows.  Exactly one
        of the two is given; a mesh implies device_linalg.
        ``device_linalg``: impute_region runs the batched f32 region
        kernel there; otherwise it loops the float64 window path (its
        correlations there, its solves on the host).  LD and
        qcat regions always run their resident kernels there.  Building
        an engine changes no process-wide setting: the resident kernels
        switch TF32 off around their own matmuls
        (``ops/window_kernel.full_f32_matmul``)."""
        if (device is None) == (mesh is None):
            raise ValueError("exactly one of device / mesh required")
        if mesh is not None:
            if tuple(mesh.axis_names) != ("window", "subject"):
                raise ValueError("engine mesh must have axes ('window', "
                                 f"'subject'), got {mesh.axis_names}")
            device_linalg = True
            device = mesh.devices[0, 0]
        self.store = store
        self.device = torch.device(device)
        self.mesh = mesh
        self.settings = settings
        self.device_linalg = device_linalg
        self._fns: Dict = {}

    def _groups(self) -> List[Tuple[torch.device, ...]]:
        """The devices of each window group, shard by shard: the mesh's
        rows, or the engine's one device."""
        if self.mesh is None:
            return [(self.device,)]
        return self.mesh.groups()

    # -- selection --------------------------------------------------------
    def _select(self, pop_flags: np.ndarray):
        sel = np.flatnonzero(pop_flags != 0)
        bounds = stats.segment_bounds(self.store.desc.sizes)
        cols = np.concatenate([np.arange(bounds[k], bounds[k + 1])
                               for k in sel])
        sizes = tuple(int(self.store.desc.sizes[k]) for k in sel)
        return sel, cols, sizes

    def _join(self, input_df: pd.DataFrame, **join_kw):
        """Join the input against the in-memory index (with unmeasured
        panel rows unless ``join_kw`` says otherwise); map fpos back to
        store rows (-1 where the panel lacks the SNP)."""
        table = variants.join_reference_index(
            input_df, self.store.index, **{"add_unmeasured": True,
                                           **join_kw})
        fmap = pd.Series(np.arange(len(self.store.index)),
                         index=self.store.index["fpos"].to_numpy())
        g_row = np.full(len(table), -1, dtype=np.int64)
        has = table["fpos"].to_numpy() >= 0
        g_row[has] = fmap.reindex(table["fpos"].to_numpy()[has]).to_numpy()
        return table, g_row, has

    def prepare_mix(self, input_df: pd.DataFrame, pop_wgt: Dict[str, float],
                    af1_cutoff: float = 0.01) -> "PreparedRun":
        """Join input against the in-memory index + AF filter, once for
        the whole region."""
        flags, wgts = readers.init_pop_flag_wgts(self.store.desc, pop_wgt)
        sel, cols, sizes = self._select(flags)
        table, g_row, has = self._join(input_df)
        af1 = np.full(len(table), np.nan)
        af1[has] = self.store.af[g_row[has]][:, sel] @ wgts
        table = table.assign(af1mix=af1)
        # type-2 rows (~has) drop like the reference's MakeSnpVecMix
        # NaN-filter drops them
        keep = has.copy()
        keep[has] = (af1[has] > af1_cutoff) & (af1[has] < 1 - af1_cutoff)
        table = table[keep].reset_index(drop=True)
        g_row = g_row[keep]
        return PreparedRun(self, table, g_row, cols, sizes,
                           tuple(float(x) for x in wgts))

    def prepare_homog(self, input_df: pd.DataFrame, study_pop: str,
                      af1_cutoff: float = 0.01) -> "PreparedRun":
        flags = readers.init_pop_flags(self.store.desc, study_pop)
        sel, cols, sizes = self._select(flags)
        table, g_row, has = self._join(input_df)
        af1 = np.full(len(table), np.nan)
        counts = self.store.G[np.ix_(g_row[has], cols)].astype(
            np.int64).sum(axis=1)
        af = counts / (2.0 * float(sum(sizes)))
        af1[has] = np.ceil(af * 1e5) / 1e5
        table = table.assign(af1ref=af1)
        # type-2 rows drop like the reference's MakeSnpVec NaN-filter
        keep = has.copy()
        keep[has] = (af1[has] > af1_cutoff) & (af1[has] < 1 - af1_cutoff)
        table = table[keep].reset_index(drop=True)
        g_row = g_row[keep]
        return PreparedRun(self, table, g_row, cols, sizes, None)

    def prepare_genes(self, input_df: pd.DataFrame, annot_df: pd.DataFrame,
                      study_pop: Optional[str] = None,
                      pop_wgt: Optional[Dict[str, float]] = None,
                      af1_cutoff: float = 0.01) -> "PreparedGenes":
        """Join input and annotation against the resident panel once, for
        genome-scale jepeg (study_pop) or jepegmix (pop_wgt): exactly one
        of the two.  The reference re-runs this pipeline on every call
        (src/jepegmix.cpp:65-91); here PreparedGenes.jepeg_region gathers
        the gene blocks from the panel on the engine's device."""
        if (study_pop is None) == (pop_wgt is None):
            raise ValueError("exactly one of study_pop / pop_wgt required")
        if pop_wgt is not None:
            flags, wgts = readers.init_pop_flag_wgts(self.store.desc, pop_wgt)
            wgts = tuple(float(x) for x in wgts)
        else:
            flags = readers.init_pop_flags(self.store.desc, study_pop)
            wgts = None
        sel, cols, sizes = self._select(flags)

        table, g_row, has = self._join(input_df, add_unmeasured=False,
                                       flip_af1study=True)
        table, categs = variants.join_annotation(table, annot_df)

        # MakeSnpVec[Mix] AF filter (src/gauss.cpp:543-693)
        n = len(table)
        af = np.full(n, np.nan)
        if wgts is None:
            counts = self.store.G[np.ix_(g_row[has], cols)].astype(
                np.int64).sum(axis=1)
            af[has] = np.ceil(counts / (2.0 * float(sum(sizes))) * 1e5) / 1e5
            table = table.assign(af1ref=af)
        else:
            af[has] = self.store.af[g_row[has]][:, sel] @ np.asarray(wgts)
            table = table.assign(af1mix=af)
        keep = has.copy()   # type-2 rows drop (MakeSnpVec NaN filter)
        keep[has] = (af[has] > af1_cutoff) & (af[has] < 1 - af1_cutoff)

        # gene SNPs: measured and annotated (src/jepeg.cpp:73-79), sorted
        # by geneid (stable, src/jepeg.cpp:87), in contiguous runs
        typ = table["type"].to_numpy()
        gid = table["geneid"].to_numpy()
        gene_rows = np.flatnonzero(keep & (typ == 1) & (gid != "."))
        cw, cp = _categ_arrays(categs, n)
        order = np.argsort(table["geneid"].to_numpy()[gene_rows],
                           kind="stable")
        gene_rows = gene_rows[order]
        sub = table.iloc[gene_rows]
        gids = sub["geneid"].to_numpy()
        starts, ends = _gene_runs(gids)
        bps = sub["bp"].to_numpy()
        gene_min_bp = np.asarray([bps[s:e].min() for s, e in
                                  zip(starts, ends)], dtype=np.int64)
        return PreparedGenes(
            engine=self, zs=sub["z"].to_numpy(),
            infos=sub["info"].to_numpy(), rsids=sub["rsid"].to_numpy(),
            gids=gids, panel_rows=g_row[gene_rows],
            spans=list(zip(starts.tolist(), ends.tolist())),
            gene_min_bp=gene_min_bp,
            cw_rows=cw[gene_rows], cp_rows=cp[gene_rows],
            subj_cols=cols, pop_sizes=sizes, wgts=wgts)

    # -- ancestry over the resident panel ---------------------------------------
    def afmix(self, input_af_df: pd.DataFrame,
              interval: Optional[int] = None) -> pd.DataFrame:
        """afmix over the decoded store (src/afmix.cpp re-reads the panel
        on every call)."""
        return ancestry.afmix_store(self.store, input_af_df, interval,
                                    self.settings)

    def cpw2(self, input_af_df: pd.DataFrame,
             interval: Optional[int] = None) -> pd.DataFrame:
        return ancestry.cpw2_store(self.store, input_af_df, interval,
                                   self.settings)

    def prep_zmix5(self, input_z_df: pd.DataFrame,
                   percentile: Optional[float] = None,
                   interval: Optional[int] = None,
                   sup_level: bool = False) -> np.ndarray:
        return ancestry.prep_zmix5_store(self.store, input_z_df,
                                         percentile, interval, sup_level,
                                         mesh=self.mesh, device=self.device)

    def zmix(self, input_z_df: pd.DataFrame, percentile: float = 0.9,
             interval: int = 10, level: str = "population") -> pd.DataFrame:
        return ancestry.zmix_store(self.store, input_z_df, percentile,
                                   interval, level, mesh=self.mesh,
                                   device=self.device)

    # -- region kernels ----------------------------------------------------
    def _padded_sizes(self, sizes) -> Tuple[int, ...]:
        """Per-pop segment widths of one device panel (of one subject
        shard with a mesh): K1's K_CHUNK multiples (the zero padding is
        exact)."""
        n = 1 if self.mesh is None else self.mesh.shape["subject"]
        return tuple(_round_up(-(-int(s) // n), K_CHUNK) for s in sizes)

    def _spec(self, sizes, wgts) -> WindowKernelSpec:
        kw = dict(lam=self.settings.lambda_,
                  min_abs_eig=self.settings.min_abs_eig,
                  eig_cutoff=self.settings.eig_cutoff)
        if self.mesh is not None:
            return sharded_spec(sizes, wgts, self.mesh.shape["subject"],
                                **kw)
        return WindowKernelSpec(
            pop_sizes=sizes, pop_sizes_padded=self._padded_sizes(sizes),
            wgts=wgts, **kw)

    def _kernel_fn(self, kind: str, sizes, wgts, *shape):
        """The resident kernel ``kind`` ("impute", "ld", "qcat") built for
        ``shape`` ((Mp, Up), or (Mp, fetch) for LD), cached."""
        key = (kind, sizes, wgts) + shape
        fn = self._fns.get(key)
        if fn is None:
            fn = _BUILDERS[kind](self._spec(sizes, wgts), *shape)
            self._fns[key] = fn
        return fn


@dataclasses.dataclass
class GroupBatch:
    """One window group's share of a RegionBatch, on its devices.  Window
    w's bands start at row m_t0[w] / u_t0[w] of the arrays' panels: its
    first measured / unmeasured row."""

    inputs: tuple          # (m_t0, u_t0, Z1, m_mask, u_mask), W padded
    compact: tuple         # (wi, ci): the group's real unmeasured rows
    arrays: tuple          # (Xm, Xu, Spm, Spu, Mum, Muu, Vu); Xm, Xu one
                           # tensor per subject shard with a mesh


@dataclasses.dataclass
class RegionBatch:
    """Device inputs of one region's windows (see
    PreparedRun._region_batch): one GroupBatch per window group, the
    groups holding consecutive blocks of the windows.  With one group
    (no mesh) its fields read through: ``inputs``, ``compact``,
    ``arrays``."""

    plans: list            # (lo, hi, window plan) per window
    groups: list           # GroupBatch per window group
    Mp: int
    Up: int
    aligned: bool          # the per-window aligned layout (own panels)

    def _one(self) -> GroupBatch:
        if len(self.groups) != 1:
            raise ValueError(f"a batch over {len(self.groups)} window "
                             f"groups: read .groups")
        return self.groups[0]

    @property
    def inputs(self) -> tuple:
        return self._one().inputs

    @property
    def compact(self) -> tuple:
        return self._one().compact

    @property
    def arrays(self) -> tuple:
        return self._one().arrays


@dataclasses.dataclass
class PreparedRun:
    engine: GenomeEngine
    table: pd.DataFrame
    g_row: np.ndarray
    subj_cols: np.ndarray
    pop_sizes: Tuple[int, ...]
    wgts: Optional[Tuple[float, ...]]
    _G_dev: Optional[torch.Tensor] = None
    _G_shards: Optional[list] = None
    _res: Dict = dataclasses.field(default_factory=dict)

    def _selected(self) -> np.ndarray:
        """The selected populations' columns of the store's panel (the
        panel itself when it selects all)."""
        G = self.engine.store.G
        cols = self.subj_cols
        full = len(cols) == G.shape[1] and bool(
            np.array_equal(cols, np.arange(G.shape[1])))
        return G if full else G[:, cols]

    def _device_panel(self) -> torch.Tensor:
        """Selected-population int8 dosage matrix on the engine's device,
        uploaded once and reused by every region.  Population segments
        are zero-padded to K_CHUNK columns (exact: zero columns add 0 to
        every statistic).  A mesh engine holds subject shards instead
        (_group_panels)."""
        if self.engine.mesh is not None:
            raise ValueError("a mesh engine's panel is split into subject "
                             "shards: _group_panels()")
        if self._G_dev is None:
            Gh = self._selected()
            padded = self.engine._padded_sizes(self.pop_sizes)
            if padded != tuple(self.pop_sizes):
                Gh, got = pad_pop_segments(Gh, self.pop_sizes,
                                           multiple=K_CHUNK)
                assert got == padded
            Gh = np.require(Gh, dtype=np.int8, requirements=["C", "W"])
            self._G_dev = torch.from_numpy(Gh).to(self.engine.device)
        return self._G_dev

    def _group_panels(self) -> List[Tuple[torch.Tensor, ...]]:
        """Each window group's panels, one per subject shard, uploaded
        once: with a mesh, shard j (its slice of every population,
        parallel/mesh.shard_columns, segments padded to K_CHUNK) on device
        [i, j], once per distinct (shard, device); else the one device
        panel."""
        if self.engine.mesh is None:
            return [(self._device_panel(),)]
        if self._G_shards is None:
            blocks, _, _ = shard_columns(self._selected(), self.pop_sizes,
                                         self.engine.mesh.shape["subject"])
            self._G_shards = place_shards(blocks, self.engine.mesh)
        return self._G_shards

    def _prepare(self, rows: np.ndarray, gi: int = 0):
        """(X, Sp, Mu, V) of panel rows ``rows`` (-1: a zero row) on window
        group gi: K2 gathers on every shard, the sums added on the group's
        lead, every shard shifted (parallel/mesh.prepare_group)."""
        return prepare_group(self._group_panels()[gi], rows,
                             self.engine._spec(self.pop_sizes, self.wgts))

    def _gkey(self, gi: int) -> tuple:
        """Cache-key suffix of window group gi's device state: groups on
        the same devices share it (none without a mesh)."""
        if self.engine.mesh is None:
            return ()
        return (self.engine._groups()[gi],)

    def _window_plan(self, start_bp: int, end_bp: int, wing_size: int):
        """Row selection for one window, or None if below the reference
        minimum SNP counts (src/dist.cpp:145-151)."""
        st = self.engine.settings
        t = self.table
        bp = t["bp"].to_numpy()
        typ = t["type"].to_numpy()
        in_ext = (bp >= start_bp - wing_size) & (bp <= end_bp + wing_size)
        m_rows = np.flatnonzero(in_ext & (typ == 1))
        u_rows = np.flatnonzero((typ == 0) & (bp >= start_bp)
                                & (bp <= end_bp))
        M, U = len(m_rows), len(u_rows)
        if M <= st.min_num_measured_snp or U <= st.min_num_unmeasured_snp:
            return None
        return m_rows, u_rows, M, U, t["z"].to_numpy()[m_rows]

    def impute_window(self, start_bp: int, end_bp: int,
                      wing_size: int) -> Optional[WindowResult]:
        """Impute one prediction window (reference semantics of
        run_distmix, src/distmix.cpp:138-253).

        With the engine's ``device_linalg`` the window runs on the
        engine's device as a one-window region through the resident
        impute kernel (K2 gathers its rows, K1 its two Grams, f32
        solves).  Its one-window batch is cached apart from the region
        batches (``_region_batch``'s "window" slot): the newest window's
        alone is kept, a repeated call on it launches with no set-up, and
        a region's batch stays cached while single windows are served
        between calls on it.  Otherwise in float64: exact sufficient
        statistics and float64 combines on the engine's device, then
        MakePosDef and an inverse on the host -- the parity anchor of the
        region kernel."""
        if self.engine.device_linalg:
            window_bp = end_bp - start_bp + 1
            b = self._region_batch(start_bp, end_bp, window_bp, wing_size,
                                   slot="window")
            if b is None:
                return None
            _, _, M, U, _ = b.plans[0][2]
            table = self.impute_region_async(start_bp, end_bp, window_bp,
                                             wing_size, _slot="window"
                                             ).result()
            return WindowResult(table=table, n_measured=M, n_unmeasured=U)
        return self._impute_window_host(start_bp, end_bp, wing_size)

    def _impute_window_host(self, start_bp: int, end_bp: int,
                            wing_size: int) -> Optional[WindowResult]:
        """impute_window's float64 path, whatever ``device_linalg`` says
        (what the device paths are checked against): B11 and B21 on the
        engine's device, the solve on the host, as gauss_tpu's
        (models/genome.py:530-545)."""
        st = self.engine.settings
        plan = self._window_plan(start_bp, end_bp, wing_size)
        if plan is None:
            return None
        m_rows, u_rows, M, U, z1 = plan
        G, dev = self.engine.store.G, self.engine.device
        Gm = torch.from_numpy(
            G[np.ix_(self.g_row[m_rows], self.subj_cols)]).to(dev)
        Gu = torch.from_numpy(
            G[np.ix_(self.g_row[u_rows], self.subj_cols)]).to(dev)
        B11, B21 = (B.cpu() for B in _build_corr_blocks_fn(
            self.pop_sizes, self.wgts)(Gm, Gu))
        B11.fill_diagonal_(1.0 + st.lambda_)
        B11 = linalg.make_pos_def(B11, st.min_abs_eig)
        A = B21 @ linalg.inv_mat(B11)
        z2 = A @ torch.from_numpy(z1)
        info = torch.abs((A * B21).sum(dim=1))
        z = z2 / torch.sqrt(info)
        return self._assemble(start_bp, end_bp, u_rows, z.numpy(),
                              info.numpy(), M, U)

    def _assemble(self, start_bp, end_bp, u_rows, z, info, M, U
                  ) -> WindowResult:
        """Output rows for the prediction window (pval = 2*Phi(-|z|),
        src/distmix.cpp:100-134)."""
        t = self.table
        bp = t["bp"].to_numpy()
        out_z = t["z"].to_numpy().copy()
        out_info = t["info"].to_numpy().copy()
        out_z[u_rows] = z
        out_info[u_rows] = info
        mask = (bp >= start_bp) & (bp <= end_bp)
        tt = t[mask]
        sel = np.flatnonzero(mask)
        af_col = "af1mix" if self.wgts is not None else "af1ref"
        res = pd.DataFrame({
            "rsid": tt["rsid"].to_numpy(),
            "chr": tt["chr"].to_numpy(),
            "bp": tt["bp"].to_numpy(),
            "a1": tt["a1"].to_numpy(),
            "a2": tt["a2"].to_numpy(),
            af_col: tt[af_col].to_numpy(),
            "z": out_z[sel],
            "pval": pnorm_two_sided(out_z[sel]),
            "info": out_info[sel],
            "type": tt["type"].to_numpy(),
        })
        return WindowResult(table=res, n_measured=M, n_unmeasured=U)

    # -- resident region batches ---------------------------------------------
    def _resident_half(self, typ_val: int, cap: int, gi: int = 0):
        """Shared layout, one half: the bp-sorted measured (typ_val 1) or
        unmeasured (0) panel rows, gathered (K2), shifted, with per-row
        statistics (prepare_resident_panel), plus ``cap`` zero rows so
        every band of up to ``cap`` rows stays inside, on window group
        gi's devices (every group holds every row).  Cached per half;
        rebuilt only if a larger cap than cached is requested, so LD,
        which reads only the measured half, never builds the other."""
        key = ("half", typ_val) + self._gkey(gi)
        cached = self._res.get(key)
        if cached is not None and cached[0] >= cap:
            return cached[1]
        if cached is not None:       # grow monotonically: alternating
            cap = max(cap, cached[0])  # callers must not thrash rebuilds
        half = self._prepare(self._half_rows(typ_val, cap), gi)
        self._res[key] = (cap, half)
        return half

    def _half_rows(self, typ_val: int, cap: int) -> np.ndarray:
        """Panel row ids one shared-layout half gathers (K2's index
        vector): the half's rows in table order, then -1 sentinels up to a
        ROW_TILE multiple plus ``cap``."""
        rows_tbl = np.flatnonzero(self.table["type"].to_numpy() == typ_val)
        n = len(rows_tbl)
        rows = np.full(_round_up(max(n, 1), ROW_TILE) + cap, -1,
                       dtype=np.int32)
        rows[:n] = self.g_row[rows_tbl]
        return rows

    def _resident_arrays(self, Mp: int, Up: int, gi: int = 0):
        """Shared layout: both halves (see _resident_half), one pair for
        every region of this run, as (Xm, Xu, Spm, Spu, Mum, Muu, Vu).
        The tuple is kept as self._res["arrays"] (with a mesh, per window
        group's devices) and stays the same object until a half is
        rebuilt (already-built batches hold the OLD arrays, still valid
        for their own bands)."""
        Xm, Spm, Mum, _ = self._resident_half(1, Mp, gi)
        Xu, Spu, Muu, Vu = self._resident_half(0, Up, gi)
        arrays = (Xm, Xu, Spm, Spu, Mum, Muu, Vu)
        gk = self._gkey(gi)
        key = ("arrays",) + gk if gk else "arrays"
        old = self._res.get(key)
        if old is None or any(a is not b for a, b in zip(arrays, old)):
            self._res[key] = arrays
        return self._res[key]

    def _window_batch(self, plans, Mp: int, Up: int, m_t0, u_t0,
                      Wp: Optional[int] = None):
        """Padded Z1/mask batch + int32 band row offsets; W is padded to
        ``Wp`` (default: a slab multiple) with empty windows."""
        W = len(plans)
        if Wp is None:
            Wp = _round_up(W, win_slab(W))
        m_off = np.zeros(Wp, dtype=np.int32)
        u_off = np.zeros(Wp, dtype=np.int32)
        m_off[:W], u_off[:W] = m_t0, u_t0
        if W:                        # padding windows: any valid band
            m_off[W:] = m_off[W - 1]
            u_off[W:] = u_off[W - 1]
        Z1b = np.zeros((Wp, Mp), dtype=np.float32)
        m_maskb = np.zeros((Wp, Mp), dtype=np.float32)
        u_maskb = np.zeros((Wp, Up), dtype=np.float32)
        for i, (_, _, plan) in enumerate(plans):
            _, _, M, U, z1 = plan
            Z1b[i, :M] = z1
            m_maskb[i, :M] = 1.0
            u_maskb[i, :U] = 1.0
        return m_off, u_off, Z1b, m_maskb, u_maskb

    def _shared_offsets(self, plans):
        """Shared layout: window w is the row band starting at its first
        measured / unmeasured row of the bp-sorted panels, (m_t0, u_t0).
        Windows select bp ranges of the bp-sorted table, so their rows
        are contiguous runs of the measured / unmeasured row lists."""
        typ = self.table["type"].to_numpy()
        m_all = np.flatnonzero(typ == 1)
        u_all = np.flatnonzero(typ == 0)
        m_t0, u_t0 = [], []
        for _, _, plan in plans:
            m_rows, u_rows, M, U, _ = plan
            mpos = int(np.searchsorted(m_all, m_rows[0]))
            upos = int(np.searchsorted(u_all, u_rows[0]))
            if m_all[mpos + M - 1] != m_rows[-1] \
                    or u_all[upos + U - 1] != u_rows[-1]:
                raise RuntimeError("window rows are not contiguous in the "
                                   "bp-sorted table")
            m_t0.append(mpos)
            u_t0.append(upos)
        return np.asarray(m_t0, dtype=np.int32), np.asarray(u_t0,
                                                             dtype=np.int32)

    @staticmethod
    def _aligned_bands(plans) -> Tuple[int, int]:
        """(Mp, Up): the aligned layout's band heights for ``plans``."""
        return (_round_up(max(p[2][2] for p in plans), ROW_TILE),
                _round_up(max(p[2][3] for p in plans), ROW_TILE))

    def _aligned_rows(self, plans, Wp: Optional[int] = None,
                      bands: Optional[Tuple[int, int]] = None
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Panel row ids the aligned layout gathers (K2's index vectors):
        window w's rows start at w*Mp / w*Up, -1 pads each band.  ``Wp``
        windows (default: a slab multiple) of heights ``bands`` (default:
        _aligned_bands(plans))."""
        Mp, Up = bands or self._aligned_bands(plans)
        if Wp is None:
            Wp = _round_up(len(plans), win_slab(len(plans)))
        rows_m = np.full(Wp * Mp, -1, dtype=np.int32)
        rows_u = np.full(Wp * Up, -1, dtype=np.int32)
        for i, (_, _, plan) in enumerate(plans):
            m_rows, u_rows, M, U, _ = plan
            rows_m[i * Mp:i * Mp + M] = self.g_row[m_rows]
            rows_u[i * Up:i * Up + U] = self.g_row[u_rows]
        return rows_m, rows_u

    def _aligned_group(self, plans, Wg: int, Mp: int, Up: int, gi: int):
        """Per-window ALIGNED layout of one window group: each window's
        measured/unmeasured rows are gathered into a dedicated band of
        their own (pad rows = -1 sentinels between bands; a group's
        padding windows own empty bands).  Measured-extended windows
        overlap (wings), so measured rows repeat across bands (~2.4x the
        rows of the shared layout).  Returns (m_t0, u_t0, arrays); arrays
        belong to this batch alone."""
        rows_m, rows_u = self._aligned_rows(plans, Wg, (Mp, Up))
        Xm, Spm, Mum, _ = self._prepare(rows_m, gi)
        Xu, Spu, Muu, Vu = self._prepare(rows_u, gi)
        return (np.arange(Wg) * Mp, np.arange(Wg) * Up,
                (Xm, Xu, Spm, Spu, Mum, Muu, Vu))

    def _aligned_fits(self, plans, Wg: int, Mp: int, Up: int) -> bool:
        """Whether the aligned layout's bands (rows x padded subject axis
        of every shard) stay under _aligned_max_bytes on every device:
        a device counts the real windows of every group shard it holds."""
        S_pad = int(sum(self.engine._padded_sizes(self.pop_sizes)))
        n_bytes = {}
        for gi, devs in enumerate(self.engine._groups()):
            n = len(plans[gi * Wg:(gi + 1) * Wg])
            for d in devs:
                n_bytes[d] = n_bytes.get(d, 0) + n * (Mp + Up) * S_pad
        return all(b <= _aligned_max_bytes(d) for d, b in n_bytes.items())

    def _region_batch(self, start_bp: int, end_bp: int, window_bp: int,
                      wing_size: int, slot: str = "batch"
                      ) -> Optional[RegionBatch]:
        """The RegionBatch of one region (impute_region's and
        qcat_region's windows), or None when no window clears the minimum
        counts.  Every window's rows start at its band's first row, in
        both layouts.

        The table is immutable after prepare, so the batch is cached per
        (start, end, window_bp, wing): repeated region calls skip the
        host-side plan, the uploads and the preparation.  ``slot`` names
        the cache the batch lives in: "batch" for regions, "window" for
        impute_window's single windows, each evicted among its own kind
        only."""
        ck = (start_bp, end_bp, window_bp, wing_size)
        hit = self._res.get((slot, ck))
        if hit is not None:
            return hit
        out = self._region_batch_build(start_bp, end_bp, window_bp,
                                       wing_size)
        # the aligned layout gives each batch DEDICATED device panels
        # (GBs at genome scale); keep only the newest such batch so a
        # sweep over distinct spans does not accumulate one per region
        # (repeat calls on one span still hit the cache above)
        def _aligned(b):
            return b is not None and b.aligned
        if _aligned(out):
            for k in [k for k in self._res
                      if isinstance(k, tuple) and k[0] == slot
                      and k[1] != ck]:
                if _aligned(self._res[k]):
                    del self._res[k]
                    self._res.pop((slot + " asm", k[1]), None)
        self._res[(slot, ck)] = out
        return out

    def _region_batch_build(self, start_bp: int, end_bp: int,
                            window_bp: int, wing_size: int):
        plans = []
        lo = start_bp
        while lo <= end_bp:
            hi = min(lo + window_bp - 1, end_bp)
            plan = self._window_plan(lo, hi, wing_size)
            if plan is not None:
                plans.append((lo, hi, plan))
            lo = hi + 1
        if not plans:
            return None
        groups = self.engine._groups()
        Wg = group_width(len(plans), len(groups))
        # the aligned layout repeats measured bands across wings; above
        # the byte cap (rows x padded subject axis) the shared bp-sorted
        # layout takes over
        Mp, Up = self._aligned_bands(plans)
        aligned = self._aligned_fits(plans, Wg, Mp, Up)
        if not aligned:
            m_all, u_all = self._shared_offsets(plans)
        parts = []
        for gi, devs in enumerate(groups):
            sl = slice(gi * Wg, (gi + 1) * Wg)
            gplans = plans[sl]
            if aligned:
                m_t0, u_t0, arrays = self._aligned_group(gplans, Wg, Mp, Up,
                                                         gi)
            else:
                m_t0, u_t0 = m_all[sl], u_all[sl]
                arrays = self._resident_arrays(Mp, Up, gi)
            inputs = self._window_batch(gplans, Mp, Up, m_t0[:len(gplans)],
                                        u_t0[:len(gplans)], Wg)
            if aligned:              # padding windows own their empty bands
                inputs[0][:] = m_t0
                inputs[1][:] = u_t0
            # compaction indices, window by window (_region_assembly's
            # order): the impute kernel keeps only REAL unmeasured rows
            wi = np.concatenate([np.full(p[2][3], i, dtype=np.int64)
                                 for i, p in enumerate(gplans)]
                                + [np.zeros(0, dtype=np.int64)])
            ci = np.concatenate([np.arange(p[2][3], dtype=np.int64)
                                 for p in gplans]
                                + [np.zeros(0, dtype=np.int64)])
            # upload the pass-invariant batch inputs once: repeated region
            # calls then launch with no host->device traffic
            parts.append(GroupBatch(
                tuple(_to_device(a, devs[0]) for a in inputs),
                tuple(_to_device(a, devs[0]) for a in (wi, ci)), arrays))
        return RegionBatch(plans, parts, Mp, Up, aligned)

    def _kernel_fn(self, kind: str, *shape):
        return self.engine._kernel_fn(kind, self.pop_sizes, self.wgts,
                                      *shape)

    def _region_assembly(self, plans):
        """Pass-invariant output skeleton for impute_region: emitted row
        selection, static output columns, and the flat scatter positions
        of the compacted kernel output.  Per pass only the value scatter
        and the pval evaluation remain."""
        t = self.table
        bp = t["bp"].to_numpy()
        emit = np.zeros(len(t), dtype=bool)
        for lo, hi, _ in plans:
            emit |= (bp >= lo) & (bp <= hi)
        sel = np.flatnonzero(emit)
        # u_rows lie inside [lo, hi] => always emitted
        pos = np.concatenate([np.searchsorted(sel, plan[1])
                              for _, _, plan in plans])
        af_col = "af1mix" if self.wgts is not None else "af1ref"
        tt = t.iloc[sel]
        return {
            "pos": pos,
            "base_z": t["z"].to_numpy()[sel],
            "base_info": t["info"].to_numpy()[sel],
            "static": {
                "rsid": tt["rsid"].to_numpy(),
                "chr": tt["chr"].to_numpy(),
                "bp": tt["bp"].to_numpy(),
                "a1": tt["a1"].to_numpy(),
                "a2": tt["a2"].to_numpy(),
                af_col: tt[af_col].to_numpy(),
                "type": tt["type"].to_numpy(),
            },
        }

    def impute_region_async(self, start_bp: int, end_bp: int,
                            window_bp: int = 1_000_000,
                            wing_size: int = 500_000,
                            _slot: str = "batch") -> "RegionHandle":
        """Launch the region's kernels WITHOUT waiting for them.

        After the first call for a span (which builds and caches its
        batch), nothing here synchronizes with the device: the Grams, the
        tail and the compaction are queued on the current stream of the
        engine's device (of each window group's devices with a mesh),
        followed by the copy of the compacted [2, N] output into pinned
        host memory.  Queuing the copy here, before the next region's
        kernels, lets ``RegionHandle.result()`` wait for THIS region only,
        so region N's assembly overlaps region N+1's kernels
        (impute_regions)."""
        if not self.engine.device_linalg:
            raise ValueError("impute_region_async requires device_linalg")
        b = self._region_batch(start_bp, end_bp, window_bp, wing_size,
                               slot=_slot)
        if b is None:
            return RegionHandle([], None)
        fn = self._kernel_fn("impute", b.Mp, b.Up)
        outs = [_copy_to_host(fn(*g.arrays, *g.inputs, *g.compact))
                for g in b.groups]
        ck = (_slot + " asm", (start_bp, end_bp, window_bp, wing_size))
        asm = self._res.get(ck)
        if asm is None:
            asm = self._region_assembly(b.plans)
            self._res[ck] = asm
        return RegionHandle(outs, asm)

    def impute_regions(self, spans, window_bp: int = 1_000_000,
                       wing_size: int = 500_000, depth: int = 2):
        """Pipelined multi-region imputation: yields (start_bp, end_bp,
        DataFrame) per span with up to ``depth`` regions in flight."""
        depth = max(int(depth), 1)      # depth<1 degrades to sequential
        pending: deque = deque()
        for lo, hi in spans:
            if len(pending) >= depth:   # cap in-flight handles at depth
                lo0, hi0, h = pending.popleft()
                yield lo0, hi0, h.result()
            pending.append((lo, hi, self.impute_region_async(
                lo, hi, window_bp, wing_size)))
        while pending:
            lo0, hi0, h = pending.popleft()
            yield lo0, hi0, h.result()

    def impute_region(self, start_bp: int, end_bp: int,
                      window_bp: int = 1_000_000,
                      wing_size: int = 500_000) -> pd.DataFrame:
        """Tile [start_bp, end_bp] with non-overlapping prediction windows
        (plus wings) and impute them all: one batched region kernel with
        device_linalg, else the float64 window path window by window."""
        frames = []
        if self.engine.device_linalg:
            res = self.impute_region_async(start_bp, end_bp,
                                           window_bp=window_bp,
                                           wing_size=wing_size).result()
            if len(res):
                frames.append(res)
        else:
            lo = start_bp
            while lo <= end_bp:
                hi = min(lo + window_bp - 1, end_bp)
                r = self.impute_window(lo, hi, wing_size)
                if r is not None:
                    frames.append(r.table)
                lo = hi + 1
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    # -- LD (computeLD) over the resident measured panel ---------------------
    def _ld_windows(self, start_bp: int, end_bp: int,
                    window_bp: int) -> List[np.ndarray]:
        """Measured-SNP row lists (ascending) of consecutive LD windows
        (computeLD tiling: wing = 0, empty windows skipped): every
        window's bounds searched at once among the measured rows sorted
        by bp."""
        if end_bp < start_bp:
            return []
        if window_bp < 1:
            raise ValueError(f"window_bp must be positive, got {window_bp}")
        t = self.table
        m_all = np.flatnonzero(t["type"].to_numpy() == 1)
        bp = t["bp"].to_numpy()[m_all]
        order = np.argsort(bp, kind="stable")
        bp = bp[order]
        lo = np.arange(start_bp, end_bp + 1, window_bp)
        hi = np.minimum(lo + (window_bp - 1), end_bp)
        a = np.searchsorted(bp, lo, side="left")
        b = np.searchsorted(bp, hi, side="right")
        return [np.sort(m_all[order[i:j]]) for i, j in zip(a, b) if j > i]

    def _ld_batches(self, windows, fetch: str):
        """(fn, [args per window group], Mp) of the resident LD launches
        over ``windows``: fn(*args) -> a group's flat float64 matrices
        (build_resident_ld_kernel), the groups holding consecutive blocks
        of the windows.  Window w's band is the measured shared-layout
        panel from its first row; Mp is the largest window's row count
        rounded up to ROW_TILE and each group's windows are padded to a
        slab multiple with windows of size 0."""
        m_all = np.flatnonzero(self.table["type"].to_numpy() == 1)
        groups = self.engine._groups()
        W = len(windows)
        Wg = group_width(W, len(groups))
        Mp = _round_up(max(len(r) for r in windows), ROW_TILE)
        m_t0 = np.zeros(Wg * len(groups), dtype=np.int32)
        m_mask = np.zeros((Wg * len(groups), Mp), dtype=np.float32)
        sizes = tuple(len(r) for r in windows) + (0,) * (len(m_t0) - W)
        for i, m_rows in enumerate(windows):
            pos = int(np.searchsorted(m_all, m_rows[0]))
            if m_all[pos + len(m_rows) - 1] != m_rows[-1]:
                raise RuntimeError("window rows are not contiguous in the "
                                   "bp-sorted table")
            m_t0[i] = pos
            m_mask[i, :len(m_rows)] = 1.0
        args = []
        for gi, devs in enumerate(groups):
            sl = slice(gi * Wg, (gi + 1) * Wg)
            n = len(windows[sl])
            if n:                      # padding windows: any valid band
                m_t0[sl][n:] = m_t0[sl][n - 1]
            Xm, Spm, Mum, _ = self._resident_half(1, Mp, gi)
            args.append((Xm, Spm, Mum, _to_device(m_t0[sl], devs[0]),
                         _to_device(m_mask[sl], devs[0]), sizes[sl]))
        return self._kernel_fn("ld", Mp, fetch), args, Mp

    def _ld_batch(self, windows, fetch: str):
        """(fn, args, Mp) of the one resident LD launch over ``windows``
        on an engine without a mesh (see _ld_batches)."""
        fn, args, Mp = self._ld_batches(windows, fetch)
        if len(args) != 1:
            raise ValueError(f"{len(args)} window groups: _ld_batches")
        return fn, args[0], Mp

    def _ld_dicts(self, windows, fetch: str) -> List[Dict]:
        """computeLD output dicts of ``windows``: one resident LD launch
        per window group, whose output is already the windows' float64
        matrices, and one copy of them all to the host."""
        if self.wgts is None:
            # computeLD is the ancestry-WEIGHTED estimator only
            # (src/computeLD.cpp:26-166 takes pop_wgt_df; the reference
            # has no pooled variant)
            raise ValueError("ld_window / ld_region require population "
                             "weights (prepare_mix)")
        if fetch not in LD_FETCH:
            raise ValueError(f"fetch must be one of {LD_FETCH}, got "
                             f"{fetch!r}")
        if not windows:
            return []
        # host spans (torch.profiler; profile_regions.py reads them)
        with record_function("ld.batch"):
            fn, args, _ = self._ld_batches(windows, fetch)
        with record_function("ld.device"):     # launch, copy, wait
            flat = _fetch_flat([fn(*a) for a in args])
        return self._ld_assemble(windows, flat, fetch)

    def _ld_assemble(self, windows, flat: np.ndarray,
                     fetch: str) -> List[Dict]:
        """The output dicts of ``windows`` from their flat float64
        matrices (_fetch_flat's): each cormat a view of ``flat``."""
        with record_function("ld.unpack"):
            cormats, off = [], 0
            for m_rows in windows:
                M = len(m_rows)
                cormats.append(flat[off:off + M * M].reshape(M, M))
                off += M * M
        with record_function("ld.snplists"):
            # one row selection for all windows, then a slice each
            snps = self.table.iloc[np.concatenate(windows)][
                ["rsid", "chr", "bp", "a1", "a2", "af1mix", "z"]]
            res, a = [], 0
            for m_rows, cormat in zip(windows, cormats):
                b = a + len(m_rows)
                res.append({
                    "snplist": snps.iloc[a:b].reset_index(drop=True),
                    "cormat": cormat,
                    "fetch": fetch,
                })
                a = b
        return res

    def ld_window(self, start_bp: int, end_bp: int,
                  fetch: str = "f32") -> Optional[Dict]:
        """Ancestry-weighted LD matrix of the window's MEASURED SNPs
        (computeLD semantics: wing = 0, unit diagonal, no ridge;
        src/computeLD.cpp:26-166), computed on the engine's device by the
        resident LD kernel as a one-window region.  Returns
        {"snplist": DataFrame, "cormat": float64 [n, n], "fetch": fetch},
        or None when the window has no measured SNP.

        ``fetch`` names the values: "f32" (default) the f32 correlations
        cast to float64; "i16tri" and "i16full" the same matrix on the
        int16 grid (round(r * 32767) / 32767 of the lower triangle,
        mirrored), |dr| <= LD_I16_MAX_ERR.  The card makes the float64
        matrix and one copy brings it to pageable host memory, whatever
        the mode.  The dict records the mode under "fetch"."""
        return next(iter(self._ld_dicts(
            self._ld_windows(start_bp, end_bp, end_bp - start_bp + 1),
            fetch)), None)

    def ld_region(self, start_bp: int, end_bp: int,
                  window_bp: int = 1_000_000,
                  fetch: str = "i16tri") -> List[Dict]:
        """ld_window over consecutive windows of ``window_bp`` (those
        without a measured SNP skipped), all in one resident LD launch
        per slab: the card computes every window's final float64 matrix,
        and one copy brings them to pageable host memory.  The windows'
        cormats are C-contiguous views of that one host buffer (a kept
        window keeps the buffer alive).

        ``fetch`` defaults to "i16tri": the int16 grid of ld_window,
        |dr| <= LD_I16_MAX_ERR ~ 1.5e-5, below the f32 statistics noise
        at 33k subjects ("i16full" gives the same values); every dict
        records the mode under "fetch".  Pass fetch="f32" for the f32
        correlations; the per-call compute_ld stays float64."""
        with record_function("ld.windows"):
            windows = self._ld_windows(start_bp, end_bp, window_bp)
        return self._ld_dicts(windows, fetch)

    # -- qcat over the region batch ------------------------------------------
    def qcat_region(self, start_bp: int, end_bp: int,
                    window_bp: int = 1_000_000,
                    wing_size: int = 500_000) -> pd.DataFrame:
        """QCAT causality tests over consecutive windows, on the engine's
        device in one resident launch per slab of windows (qcatmix
        semantics when prepared with weights, qcat otherwise; reference
        src/qcat.cpp:134-262).  The windows and their batch are
        impute_region's.  NOTE the reference defaults differ: qcat's
        af1_cutoff is 0.05 (src/qcat.cpp:52-56) but qcatmix's is 0.01
        (src/qcatmix.cpp:61-64) -- pass the matching value to
        prepare_homog / prepare_mix.  Raises ValueError when lambda <=
        eig_cutoff (the device path counts every measured SNP as a
        principal component, which only holds above the cutoff)."""
        with record_function("qcat.batch"):
            b = self._region_batch(start_bp, end_bp, window_bp, wing_size)
        if b is None:
            return pd.DataFrame()
        with record_function("qcat.device"):   # launch, copy, wait
            fn = self._kernel_fn("qcat", b.Mp, b.Up)
            raw = _fetch_all([_copy_to_host(fn(*g.arrays, *g.inputs))
                              for g in b.groups])
        Mp, Up = b.Mp, b.Up
        t_m, chi_m = raw[:, :Mp], raw[:, Mp:2 * Mp]
        t_u, chi_u = raw[:, 2 * Mp:2 * Mp + Up], raw[:, 2 * Mp + Up:-1]
        n_eig = raw[:, -1]

        with record_function("qcat.scatter"):
            t = self.table
            bp = t["bp"].to_numpy()
            qm = np.zeros(len(t), dtype=np.int64)
            qt = np.zeros(len(t))
            qc = np.zeros(len(t))
            emit = np.zeros(len(t), dtype=bool)
            for i, (lo, hi, plan) in enumerate(b.plans):
                m_rows, u_rows, M, U, _ = plan
                pm = (bp[m_rows] >= lo) & (bp[m_rows] <= hi)
                rows = m_rows[pm]
                qm[rows] = int(n_eig[i])
                qt[rows] = t_m[i, :M][pm].astype(np.float64)
                qc[rows] = chi_m[i, :M][pm].astype(np.float64)
                qm[u_rows] = int(n_eig[i])
                qt[u_rows] = t_u[i, :U].astype(np.float64)
                qc[u_rows] = chi_u[i, :U].astype(np.float64)
                emit |= (bp >= lo) & (bp <= hi)
        with record_function("qcat.frame"):
            tt = t[emit]
            sel = np.flatnonzero(emit)
            af_col = "af1mix" if self.wgts is not None else "af1ref"
            return pd.DataFrame({
                "rsid": tt["rsid"].to_numpy(),
                "chr": tt["chr"].to_numpy(),
                "bp": tt["bp"].to_numpy(),
                "a1": tt["a1"].to_numpy(),
                "a2": tt["a2"].to_numpy(),
                af_col: tt[af_col].to_numpy(),
                "z": tt["z"].to_numpy(),
                "qcat_m": qm[sel],
                "qcat_t": qt[sel],
                "qcat_chisq": qc[sel],
                "qcat_pval": pchisq_upper(qc[sel], 1),
                "type": tt["type"].to_numpy(),
            })


def _copy_to_host(out: torch.Tensor):
    """(host tensor, ready event): one copy of a kernel's whole output
    into pinned host memory, queued on the stream of out's device without
    waiting for it; ``ready`` fires when the copy has landed (None when
    out is on the CPU already)."""
    if not out.is_cuda:
        return out, None
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    # out's device need not be the current device: record the event on
    # its stream
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(out.device))
    return host, ready


def _fetch_flat(outs) -> np.ndarray:
    """One pageable float64 host array of the window groups' flat
    outputs, in group order: each copied straight from its device (never
    through pinned memory, which a caller who keeps the results would
    hold in torch's pinned host cache).  The array is a fresh anonymous
    mapping whose pages the kernel faults in at once (MAP_POPULATE), not
    one trap per page during the copy (profile_regions.py times both)."""
    n = sum(o.numel() for o in outs)
    host = np.frombuffer(mmap.mmap(-1, 8 * n, flags=mmap.MAP_PRIVATE
                                   | mmap.MAP_ANONYMOUS | mmap.MAP_POPULATE),
                         dtype=np.float64)
    off = 0
    for o in outs:
        torch.from_numpy(host[off:off + o.numel()]).copy_(o)
        off += o.numel()
    return host


def _fetch_all(copies, axis: int = 0) -> np.ndarray:
    """Wait for each (host tensor, ready event) of _copy_to_host, one per
    window group, and join their arrays along ``axis`` in group order."""
    arrays = []
    for host, ready in copies:
        if ready is not None:
            ready.synchronize()
        arrays.append(host.numpy())
    return arrays[0] if len(arrays) == 1 else np.concatenate(arrays, axis)


class RegionHandle:
    """In-flight region imputation (see impute_region_async): the host
    copies of the compacted [2, N] output, one per window group (complete
    once its event fires; no event on the CPU), and the precomputed
    assembly skeleton.  .result() waits for this region alone, on every
    window group's lead device, and assembles the frame."""

    __slots__ = ("_outs", "_asm", "_frame")

    def __init__(self, outs, asm):
        self._outs = outs
        self._asm = asm
        self._frame = None

    def result(self) -> pd.DataFrame:
        if self._frame is None:
            if not self._outs:
                self._frame = pd.DataFrame()
            else:
                zi = _fetch_all(self._outs, axis=1)
                self._outs = None
                asm = self._asm
                out_z = asm["base_z"].copy()
                out_info = asm["base_info"].copy()
                out_z[asm["pos"]] = zi[0].astype(np.float64)
                out_info[asm["pos"]] = zi[1].astype(np.float64)
                cols = dict(asm["static"])
                typ = cols.pop("type")
                cols.update(z=out_z, pval=pnorm_two_sided(out_z),
                            info=out_info, type=typ)
                self._frame = pd.DataFrame(cols, copy=False)
        return self._frame


@dataclasses.dataclass
class PreparedGenes:
    """Gene-grouped join product for engine-resident jepeg/jepegmix.

    Arrays are aligned to the geneid-sorted gene-SNP order; ``spans``
    gives each gene's [start, end) slice and ``panel_rows`` the PanelStore
    row of every gene SNP.  The selected populations' panel goes to the
    engine's device once (per PreparedGenes) and every jepeg_region call
    gathers its gene blocks there with K2."""

    engine: GenomeEngine
    zs: np.ndarray
    infos: np.ndarray
    rsids: np.ndarray
    gids: np.ndarray
    panel_rows: np.ndarray
    spans: List[Tuple[int, int]]
    gene_min_bp: np.ndarray
    cw_rows: np.ndarray
    cp_rows: np.ndarray
    subj_cols: np.ndarray
    pop_sizes: Tuple[int, ...]
    wgts: Optional[Tuple[float, ...]]
    _G_dev: Optional[object] = None
    _local_sizes: Optional[Tuple[int, ...]] = None

    def _device_panel(self):
        """The selected populations' int8 panel on the engine's device,
        uploaded once: unpadded population segments (the gene statistics
        slice them by segment_bounds(pop_sizes)), then zero columns up to
        a multiple of 16, the row width K2 takes on a card.  With a mesh,
        one tuple of subject-shard panels per window group instead: shard
        j's slice of every population (subject_shard_layout, local widths
        in _local_sizes), then zero columns up to a multiple of 16, on
        device [i, j]."""
        if self._G_dev is None:
            G = self.engine.store.G
            cols = self.subj_cols
            S = len(cols)
            # one population or all of them: a column range, no copy
            span = S and np.array_equal(cols, np.arange(cols[0],
                                                        cols[0] + S))
            Gs = G[:, cols[0]:cols[0] + S] if span else G[:, cols]
            mesh = self.engine.mesh
            if mesh is not None:
                blocks, self._local_sizes, _ = shard_columns(
                    Gs, self.pop_sizes, mesh.shape["subject"], multiple=1)
                self._G_dev = place_shards([_pad_cols(b, 16) for b in blocks],
                                           mesh)
            else:
                self._G_dev = torch.from_numpy(_pad_cols(Gs, 16)).to(
                    self.engine.device)
        return self._G_dev

    def _gene_inputs(self, gsel: np.ndarray):
        """(panel row ids, W [6, n_g], z) per selected gene."""
        spans = [self.spans[i] for i in gsel]
        sqrt_info = np.sqrt(self.infos)
        return ([self.panel_rows[s:e] for s, e in spans],
                [(self.cw_rows[s:e] * sqrt_info[s:e, None]).T
                 for s, e in spans],
                [self.zs[s:e] for s, e in spans])

    def _select(self, start_bp: Optional[int], end_bp: Optional[int]
                ) -> np.ndarray:
        lo = -np.inf if start_bp is None else start_bp
        hi = np.inf if end_bp is None else end_bp
        return np.flatnonzero((self.gene_min_bp >= lo)
                              & (self.gene_min_bp <= hi))

    def jepeg_region(self, start_bp: Optional[int] = None,
                     end_bp: Optional[int] = None) -> pd.DataFrame:
        """Gene tests for every gene whose FIRST SNP lies in [start_bp,
        end_bp] (None: unbounded), so that chunked genome-wide runs
        partition the gene set exactly (the reference loops genes
        serially, src/jepegmix.cpp:122-139).  The O(n^2) per-gene work
        (CorG, CovU, WWt, U) runs batched on the engine's device; only the
        k <= 6 category pruning and chi-square stay on the host."""
        gsel = self._select(start_bp, end_bp)
        if len(gsel) == 0:
            return empty_gene_frame()
        idx, Ws, zs = self._gene_inputs(gsel)
        panel = self._device_panel()     # sets _local_sizes with a mesh
        stats6 = genekernels.gene_stats_resident(
            panel, idx, Ws, zs, self.pop_sizes, self.wgts,
            lam=self.engine.settings.lambda_,
            local_pop_sizes=self._local_sizes)
        return run_gene_tests_stats(
            self.zs, self.rsids, self.gids, [self.spans[i] for i in gsel],
            stats6, self.cp_rows, self.engine.settings)


def _build_corr_blocks_fn(pop_sizes, wgts):
    """(Gm [M,S] int8, Gu [U,S] int8) -> (B11 f64 [M,M], B21 f64 [U,M])
    correlation blocks on the blocks' device, their f32 products in full
    f32 (diagonals NOT ridged; the caller applies that)."""
    bounds = stats.segment_bounds(pop_sizes)

    if wgts is None:
        def fn(Gm, Gu):
            with full_f32_matmul():
                return (stats.pooled_corr_matrix(Gm, Gm),
                        stats.pooled_corr_matrix(Gu, Gm))
        return fn

    m64 = np.asarray(pop_sizes, dtype=np.float64)
    w64 = np.asarray(wgts, dtype=np.float64)

    def fn(Gm, Gu):
        with full_f32_matmul():
            C_mm = stats.pop_cross_products(Gm, Gm, bounds)
            C_um = stats.pop_cross_products(Gu, Gm, bounds)
        S_m, Q_m = stats.pop_row_stats(Gm, bounds)
        S_u, Q_u = stats.pop_row_stats(Gu, bounds)
        var_m = stats.wgt_var_combine(Q_m, S_m, m64, w64)
        var_u = stats.wgt_var_combine(Q_u, S_u, m64, w64)
        one = torch.ones((), dtype=torch.float64, device=var_m.device)
        std_m = torch.sqrt(torch.where(var_m > 0, var_m, one))
        std_u = torch.sqrt(torch.where(var_u > 0, var_u, one))
        cov_mm = stats.wgt_cov_combine(C_mm, S_m, S_m, m64, w64)
        cov_um = stats.wgt_cov_combine(C_um, S_u, S_m, m64, w64)
        return (cov_mm / (std_m[:, None] * std_m[None, :]),
                cov_um / (std_u[:, None] * std_m[None, :]))
    return fn

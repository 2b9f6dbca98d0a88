"""Genome-scale run orchestration: chunking, checkpoint/resume, failure
tolerance, tracing.

The reference has NO in-process checkpointing (SURVEY.md section 5): a
genome-wide analysis is the user's shell loop over windows, a crashed
window is re-run by hand, and the only "resume" primitive is the bgzf
virtual-offset index.  This module replaces that:

* a run is a directory: ``manifest.json`` (chunk ledger, atomic
  rewrites) + one parquet result shard per completed chunk + a JSONL
  trace of phase timings;
* chunks are contiguous bp ranges, each imputed windowed via
  GenomeEngine.impute_region -- big enough to amortize the one-dispatch
  region kernel, small enough that a crash loses at most one chunk;
* failures are caught per chunk, recorded in the manifest with the
  error, and do NOT kill the run (the reference's fail-fast Rcpp::stop
  semantics stay available per-window via the plain APIs);
* ``resume=True`` skips completed chunks and retries failed ones, so a
  preempted job continues where it stopped.

Chunks run one at a time, so a chunk's ``elapsed`` is its own time: its
preparation, its kernels, its fetch and its shard write.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
import traceback
from typing import Dict, Optional

import numpy as np
import pandas as pd

from ..io import native
from ..utils.timing import Tracer, NULL_TRACER
from .genome import GenomeEngine, PanelStore

MANIFEST = "manifest.json"


def _atomic_write_json(path: str, obj) -> None:
    d = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(obj, fh, indent=1)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@dataclasses.dataclass
class ChunkState:
    chrom: int
    start_bp: int
    end_bp: int
    status: str = "pending"        # pending | done | failed
    n_rows: int = 0
    n_imputed: int = 0
    elapsed: float = 0.0
    error: Optional[str] = None

    @property
    def key(self) -> str:
        return f"{self.chrom}_{self.start_bp}_{self.end_bp}"


class GenomeRunner:
    """Checkpointed windowed imputation over a whole region/chromosome.

    >>> runner = GenomeRunner(run_dir, engine, input_df, pop_wgt)
    >>> runner.plan(chrom=22, start_bp=..., end_bp=...)
    >>> runner.run(resume=True)
    >>> df = runner.collect()
    """

    def __init__(self, run_dir: str, engine: GenomeEngine,
                 input_df: pd.DataFrame,
                 pop_wgt: Optional[Dict[str, float]] = None,
                 af1_cutoff: float = 0.01,
                 window_bp: int = 1_000_000,
                 wing_size: int = 500_000,
                 chunk_bp: int = 16_000_000,
                 tracer: Tracer = NULL_TRACER,
                 panel_files=None,
                 analysis: str = "impute",
                 study_pop: Optional[str] = None,
                 annot_df: Optional[pd.DataFrame] = None):
        """``engine`` holds the resident panel.  With ``panel_files``
        set (a PanelFiles), the runner instead runs in STREAMING mode:
        each chunk decodes only its own [start - wing, end + wing]
        panel range into the engine, so a whole-chromosome run never
        holds more than the chunk in flight and the one being prepared
        in host and device memory (SURVEY.md section 7 hard-part 5) --
        the engine's kernel closures are shape-keyed and reused across
        chunks."""
        self.run_dir = run_dir
        self.engine = engine
        self.input_df = input_df
        self.pop_wgt = pop_wgt
        self.af1_cutoff = af1_cutoff
        self.window_bp = window_bp
        self.wing_size = wing_size
        self.chunk_bp = chunk_bp
        self.tracer = tracer
        self.panel_files = panel_files
        if analysis not in ("impute", "qcat", "jepeg", "ld"):
            raise ValueError(f"unknown analysis '{analysis}'")
        if (pop_wgt is None) == (study_pop is None):
            raise ValueError("exactly one of pop_wgt (cosmopolitan) / "
                             "study_pop (homogeneous) required")
        if analysis == "jepeg" and annot_df is None:
            raise ValueError("analysis='jepeg' needs annot_df "
                             "(readers.read_annotation output)")
        if analysis == "ld" and pop_wgt is None:
            raise ValueError("analysis='ld' is the ancestry-weighted "
                             "computeLD path and needs pop_wgt")
        self.analysis = analysis
        self.study_pop = study_pop
        self.annot_df = annot_df
        self.chunks: Dict[str, ChunkState] = {}
        self._run = None
        self._prefetch: Dict[str, object] = {}
        os.makedirs(os.path.join(run_dir, "results"), exist_ok=True)
        self._load_manifest()

    # -- manifest ---------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.run_dir, MANIFEST)

    def _load_manifest(self) -> None:
        path = self._manifest_path()
        if os.path.exists(path):
            with open(path) as fh:
                data = json.load(fh)
            mismatches = []
            for name, ours in (("window_bp", self.window_bp),
                               ("wing_size", self.wing_size),
                               ("chunk_bp", self.chunk_bp),
                               ("af1_cutoff", self.af1_cutoff),
                               ("analysis", self.analysis),
                               ("study_pop", self.study_pop)):
                stored = data.get(name)
                if stored is not None and stored != ours:
                    mismatches.append(
                        f"{name}: manifest has {stored!r}, got {ours!r}")
            if mismatches:
                raise ValueError(
                    f"run dir {self.run_dir} was created with different "
                    "parameters (resuming would mix heterogeneous "
                    "shards): " + "; ".join(mismatches))
            for c in data.get("chunks", []):
                cs = ChunkState(**c)
                self.chunks[cs.key] = cs

    def _save_manifest(self) -> None:
        _atomic_write_json(self._manifest_path(), {
            "analysis": self.analysis,
            "study_pop": self.study_pop,
            "window_bp": self.window_bp,
            "wing_size": self.wing_size,
            "chunk_bp": self.chunk_bp,
            "af1_cutoff": self.af1_cutoff,
            "updated": time.time(),
            "chunks": [dataclasses.asdict(c) for c in self.chunks.values()],
        })

    # -- planning ---------------------------------------------------------
    def plan(self, chrom: int, start_bp: Optional[int] = None,
             end_bp: Optional[int] = None) -> None:
        """Lay out chunk boundaries; no-op for chunks already planned
        (so a resumed run keeps its ledger)."""
        if start_bp is None or end_bp is None:
            if self.engine.store is None:
                raise ValueError("streaming mode needs explicit "
                                 "start_bp/end_bp")
            idx = self.engine.store.index
            if start_bp is None:
                start_bp = int(idx["bp"].min())
            if end_bp is None:
                end_bp = int(idx["bp"].max())
        lo = start_bp
        while lo <= end_bp:
            hi = min(lo + self.chunk_bp - 1, end_bp)
            cs = ChunkState(chrom=chrom, start_bp=lo, end_bp=hi)
            if cs.key not in self.chunks:
                self.chunks[cs.key] = cs
            lo = hi + 1
        self._save_manifest()

    # -- execution --------------------------------------------------------
    def _prepare_engine(self):
        """One prepare (join + AF filter) appropriate to the analysis
        and population mode."""
        if self.analysis == "jepeg":
            return self.engine.prepare_genes(
                self.input_df, self.annot_df, study_pop=self.study_pop,
                pop_wgt=self.pop_wgt, af1_cutoff=self.af1_cutoff)
        if self.pop_wgt is not None:
            return self.engine.prepare_mix(self.input_df, self.pop_wgt,
                                           af1_cutoff=self.af1_cutoff)
        return self.engine.prepare_homog(self.input_df, self.study_pop,
                                         af1_cutoff=self.af1_cutoff)

    def _decode_chunk_store(self, cs: ChunkState) -> PanelStore:
        return PanelStore.from_bgzf(
            self.panel_files, chrom=cs.chrom,
            start_bp=cs.start_bp - self.wing_size,
            end_bp=cs.end_bp + self.wing_size)

    def _prepared(self, cs: Optional[ChunkState] = None):
        if self.panel_files is not None and cs is not None:
            # streaming: decode this chunk's panel range (plus wings)
            # and prepare against it; the engine's kernel closures are
            # shape-keyed, so they carry over between chunks.  run()
            # prefetches the NEXT chunk's decode on a worker thread
            # while this chunk computes (zlib/numpy release the GIL),
            # so on all but the first chunk the future is already done.
            fut = self._prefetch.pop(cs.key, None)
            with self.tracer.phase("decode_chunk", key=cs.key,
                                   prefetched=fut is not None):
                self.engine.store = (fut.result() if fut is not None
                                     else self._decode_chunk_store(cs))
            with self.tracer.phase("prepare_chunk", key=cs.key):
                return self._prepare_engine()
        if self._run is None:
            with self.tracer.phase("prepare", snps=len(self.input_df)):
                self._run = self._prepare_engine()
        return self._run

    def _result_path(self, cs: ChunkState) -> str:
        return os.path.join(self.run_dir, "results", f"{cs.key}.parquet")

    def run(self, resume: bool = True,
            max_failures: Optional[int] = None) -> Dict[str, int]:
        """Execute chunks.  ``resume=True`` skips completed chunks and
        retries failed ones; ``resume=False`` (restart) recomputes
        EVERYTHING, failed chunks included.
        Returns {'done': n, 'failed': n, 'skipped': n}."""
        stats = {"done": 0, "failed": 0, "skipped": 0}
        if not resume:
            for cs in self.chunks.values():
                cs.status = "pending"
                cs.error = None
        queue = []
        for cs in list(self.chunks.values()):
            if cs.status == "done" and resume:
                stats["skipped"] += 1
            else:
                queue.append(cs)
        # streaming mode: decode chunk N+1's panel on a worker thread
        # while chunk N computes on the device (zlib/numpy inflate
        # releases the GIL, so decode and device compute overlap)
        self._prefetch = {}
        executor = None
        if self.panel_files is not None and len(queue) > 1:
            import concurrent.futures
            # the native decoder builds on first use: build it here, on
            # this thread, so the worker and the first chunk's own decode
            # never build at once
            native.available()
            executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="gauss-prefetch")
        try:
            self._run_queue(queue, stats, executor, max_failures)
        finally:
            if executor is not None:
                executor.shutdown(wait=False, cancel_futures=True)
            self._prefetch = {}
        return stats

    def _record_done(self, cs, df) -> None:
        df.to_parquet(self._result_path(cs))
        cs.status = "done"
        cs.error = None
        cs.n_rows = int(len(df))
        cs.n_imputed = (int((df["type"] == 0).sum())
                        if len(df) and "type" in df.columns else 0)

    def _record_fail(self, cs, e) -> None:
        cs.status = "failed"
        cs.error = f"{type(e).__name__}: {e}\n" + traceback.format_exc(
            limit=5)

    def _run_queue(self, queue, stats, executor,
                   max_failures: Optional[int]) -> None:
        # one chunk at a time, each fetched and written before the next is
        # prepared: a chunk's kernels are a small part of its wall (the
        # batch build and the shard write are the rest), and a loop that
        # kept one chunk's handle pending while the next was dispatched
        # gained nothing measurable on an H100 (profile_runner.py)
        for qi, cs in enumerate(queue):
            if executor is not None and qi + 1 < len(queue):
                nxt = queue[qi + 1]
                if nxt.key not in self._prefetch:
                    self._prefetch[nxt.key] = executor.submit(
                        self._decode_chunk_store, nxt)
            t0 = time.time()
            try:
                with self.tracer.phase("chunk", key=cs.key):
                    run = self._prepared(cs)
                    if self.analysis == "impute":
                        df = run.impute_region(cs.start_bp, cs.end_bp,
                                               window_bp=self.window_bp,
                                               wing_size=self.wing_size)
                    elif self.analysis == "qcat":
                        df = run.qcat_region(cs.start_bp, cs.end_bp,
                                             window_bp=self.window_bp,
                                             wing_size=self.wing_size)
                    elif self.analysis == "jepeg":
                        df = run.jepeg_region(cs.start_bp, cs.end_bp)
                    else:  # ld
                        blocks = run.ld_region(cs.start_bp, cs.end_bp,
                                               window_bp=self.window_bp)
                        df = self._save_ld_blocks(cs, blocks)
                self._record_done(cs, df)
                stats["done"] += 1
            except KeyboardInterrupt:
                raise
            except Exception as e:  # failure tolerance: record + continue
                self._record_fail(cs, e)
                stats["failed"] += 1
                if (max_failures is not None
                        and stats["failed"] >= max_failures):
                    cs.elapsed = time.time() - t0
                    self._save_manifest()
                    raise
            cs.elapsed = time.time() - t0
            self._save_manifest()

    def _ld_matrix_path(self, cs: ChunkState) -> str:
        return os.path.join(self.run_dir, "results", f"{cs.key}_cormat.npz")

    def _save_ld_blocks(self, cs: ChunkState, blocks) -> pd.DataFrame:
        """Persist one chunk of computeLD windows: the dense matrices go
        to a per-chunk .npz (one array per window), the snplists into the
        regular parquet shard with ``window`` id and ``fetch`` mode
        columns (the engine default is the quantized i16tri transfer,
        |dr| <= ~1.5e-5 -- recorded so consumers can tell)."""
        np.savez_compressed(self._ld_matrix_path(cs),
                            **{f"w{i}": b["cormat"]
                               for i, b in enumerate(blocks)})
        frames = []
        for i, b in enumerate(blocks):
            sl = b["snplist"].copy()
            sl.insert(0, "window", i)
            sl["fetch"] = b.get("fetch", "f32")
            frames.append(sl)
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def collect_ld(self):
        """Reassemble computeLD results: [{'snplist': df, 'cormat': arr}]
        over all completed chunks in genomic order."""
        if self.analysis != "ld":
            raise ValueError("collect_ld() is for analysis='ld' runs")
        out = []
        for cs in sorted(self.chunks.values(),
                         key=lambda c: (c.chrom, c.start_bp)):
            if cs.status != "done":
                continue
            path = self._result_path(cs)
            mpath = self._ld_matrix_path(cs)
            if not (os.path.exists(path) and os.path.exists(mpath)):
                continue
            snl = pd.read_parquet(path)
            with np.load(mpath) as mats:
                for i in sorted({int(w) for w in snl["window"]} if len(snl)
                                else set()):
                    out.append({
                        "snplist": snl[snl["window"] == i].drop(
                            columns="window").reset_index(drop=True),
                        "cormat": mats[f"w{i}"],
                    })
        return out

    # -- results ----------------------------------------------------------
    def collect(self) -> pd.DataFrame:
        """Concatenate all completed chunk shards in genomic order.
        A done chunk whose shard file vanished is a hole in the output,
        not a normal condition -- warn loudly instead of silently
        emitting a shorter result."""
        import warnings
        frames = []
        for cs in sorted(self.chunks.values(),
                         key=lambda c: (c.chrom, c.start_bp)):
            if cs.status == "done":
                path = self._result_path(cs)
                if os.path.exists(path):
                    frames.append(pd.read_parquet(path))
                else:
                    warnings.warn(
                        f"chunk {cs.key} is marked done but its result "
                        f"shard is missing ({path}); output will have a "
                        "hole -- rerun with resume after deleting the "
                        "chunk from the manifest", RuntimeWarning)
        if not frames:
            return pd.DataFrame()
        return pd.concat(frames, ignore_index=True)

    def status(self) -> Dict[str, int]:
        out = {"pending": 0, "done": 0, "failed": 0}
        for cs in self.chunks.values():
            out[cs.status] = out.get(cs.status, 0) + 1
        return out

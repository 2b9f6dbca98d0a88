"""Multi-host runs: one process per host, each driving its own devices.

The reference is strictly single-process (SURVEY.md section 2.3); this is
gauss_tpu's scale-out design (its parallel/distributed.py) for torch:

* **within a host**, one process drives a (window x subject) mesh of its
  own devices (``parallel/mesh.py``, ``global_mesh``);
* **across hosts**, windows are independent, so each process owns a
  contiguous block of the windows (``host_window_ranges``), runs its own
  checkpointed GenomeRunner under ``run_dir/hostNNN`` -- decoding only
  its own panel range in streaming mode -- and the processes meet only
  at a barrier and at the result shards (``run_genome_multihost``).  No
  genotype byte crosses between processes; only barriers cross the
  process group.

Process bootstrap is torchrun's environment::

    torchrun --nnodes 2 --nproc-per-node 1 ... -m gauss_tpu_torch \\
        impute-genome ... --multihost

``initialize`` reads MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK and
starts a gloo process group; without them it does nothing, so the same
program runs as one process unchanged.
"""

from __future__ import annotations

import json
import os
import sys
import warnings
from typing import Optional, Tuple

import pandas as pd
import torch
import torch.distributed as dist

ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize() -> None:
    """Join the process group torchrun's environment describes (gloo,
    ``init_method="env://"``).  A no-op when the environment lacks one
    of MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK, or when the group
    already exists."""
    if not all(os.environ.get(k) for k in ENV) or dist.is_initialized():
        return
    dist.init_process_group("gloo", init_method="env://",
                            world_size=int(os.environ["WORLD_SIZE"]),
                            rank=int(os.environ["RANK"]))


def shutdown() -> None:
    """Leave the process group initialize joined (a no-op without one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_info() -> Tuple[int, int]:
    """(num_processes, process_id) of the running job; (1, 0) when no
    process group was initialized."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def barrier(name: str) -> None:
    """Wait until every process has reached the barrier (a no-op with one
    process).  ``name`` labels it in errors."""
    if process_info()[0] == 1:
        return
    try:
        dist.barrier()
    except Exception as e:
        raise RuntimeError(f"barrier {name!r} failed: {e}") from e


def global_mesh(n_window: Optional[int] = None,
                n_subject: Optional[int] = None, device_type: str = "cuda"):
    """(window x subject) mesh over THIS host's devices (processes share
    nothing but files, so a mesh never spans hosts).  Defaults: the
    subject axis spans the host's devices and the window axis is 1."""
    from .mesh import make_mesh

    if device_type == "cuda":
        n_local = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        devices = [torch.device("cuda", i) for i in range(n_local)]
    else:
        n_local = 1
        devices = [torch.device(device_type)]
    if n_subject is None:
        n_subject = max(n_local, 1)
    if n_window is None:
        n_window = max(n_local // n_subject, 1)
    if device_type != "cuda":
        devices = devices * (n_window * n_subject)
    elif n_window * n_subject != n_local:
        raise ValueError(f"mesh {n_window}x{n_subject} != {n_local} devices")
    return make_mesh(n_window, n_subject, devices=devices)


def host_window_ranges(start_bp: int, end_bp: int, window_bp: int,
                       num_hosts: int, host_id: int) -> Tuple[int, int]:
    """Contiguous bp sub-range of [start_bp, end_bp] owned by one host
    when windows are striped across hosts in contiguous blocks (keeps
    each host's panel decode to one bp range)."""
    n_windows = max(1, -(-(end_bp - start_bp + 1) // window_bp))
    per = -(-n_windows // num_hosts)
    lo_w = host_id * per
    hi_w = min(n_windows, lo_w + per)
    if lo_w >= n_windows:
        return (end_bp + 1, end_bp)     # empty range
    lo = start_bp + lo_w * window_bp
    hi = min(end_bp, start_bp + hi_w * window_bp - 1)
    return (lo, hi)


def host_run_dir(run_dir: str, process_id: Optional[int] = None) -> str:
    """Per-host ledger directory under a shared run dir: hosts write
    disjoint manifests/shards, so no cross-process file races."""
    if process_id is None:
        process_id = process_info()[1]
    return os.path.join(run_dir, f"host{process_id:03d}")


def run_genome_multihost(make_runner, chrom: int, start_bp: int,
                         end_bp: int, window_bp: int, run_dir: str):
    """Genome-scale run striped across hosts: each host owns a contiguous
    window block (host_window_ranges) and runs its own checkpointed
    GenomeRunner in ``run_dir/hostNNN``; only result shards cross host
    boundaries.  ``make_runner(host_dir, lo, hi)`` builds the runner for
    one host's sub-range.

    Every host reaches the barrier, even one whose chunks all failed;
    such a host then raises, rather than merging silence for its range.
    Returns the merged DataFrame on process 0, None elsewhere."""
    num, pid = process_info()
    lo, hi = host_window_ranges(start_bp, end_bp, window_bp, num, pid)
    all_failed_msg = None
    if lo <= hi:
        runner = make_runner(host_run_dir(run_dir, pid), lo, hi)
        runner.plan(chrom, lo, hi)
        stats = runner.run()
        if stats["failed"]:
            # surface per-host failures before the barrier so a wedged
            # chunk doesn't look like a hang on the other hosts
            print(f"[gauss_tpu_torch] host {pid}: {stats['failed']} "
                  "chunk(s) failed (see manifest)", file=sys.stderr)
        if stats["done"] + stats["skipped"] == 0:
            first = next((c for c in runner.chunks.values()
                          if c.status == "failed"), None)
            detail = ((first.error or "").splitlines()[0]
                      if first is not None else "no chunks planned")
            all_failed_msg = (
                f"host {pid}: every chunk failed; merging would emit "
                f"silence for [{lo}, {hi}] (first error: {detail})")
    barrier("gauss_tpu_torch:genome_multihost")
    if all_failed_msg is not None:
        raise RuntimeError(all_failed_msg)
    if pid != 0:
        return None
    return collect_multihost(run_dir)


def collect_multihost(run_dir: str) -> pd.DataFrame:
    """Concatenate every host's completed shards in genomic order."""
    hosts = sorted(d for d in os.listdir(run_dir) if d.startswith("host"))
    entries = []
    for h in hosts:
        mpath = os.path.join(run_dir, h, "manifest.json")
        if not os.path.exists(mpath):
            continue
        with open(mpath) as fh:
            man = json.load(fh)
        for c in man.get("chunks", []):
            if c["status"] != "done":
                continue
            key = f"{c['chrom']}_{c['start_bp']}_{c['end_bp']}"
            entries.append((c["chrom"], c["start_bp"],
                            os.path.join(run_dir, h, "results",
                                         f"{key}.parquet")))
    frames = []
    for _, _, path in sorted(entries):
        if os.path.exists(path):
            frames.append(pd.read_parquet(path))
        else:
            warnings.warn(
                f"multihost merge: chunk marked done but shard missing "
                f"({path}); merged output will have a hole", RuntimeWarning)
    if not frames:
        return pd.DataFrame()
    return pd.concat(frames, ignore_index=True)

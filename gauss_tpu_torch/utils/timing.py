"""Phase timing + structured progress observability.

The reference's only observability is a console progress bar and phase
prints (reference: LoadProgressBar src/util.cpp:449-461); this module is
green-field: hierarchical phase timers, optional JSON event log, and a
torch.profiler hook for device traces.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Phase:
    name: str
    start: float
    elapsed: float = 0.0
    meta: Dict = field(default_factory=dict)


class Tracer:
    """Lightweight hierarchical phase tracer.

    Usage::

        tr = Tracer(verbose=True)
        with tr.phase("decode", rows=1234):
            ...
        tr.report()   # per-phase wall times
    """

    def __init__(self, verbose: bool = False, log_file: Optional[str] = None):
        self.verbose = verbose
        self.phases: List[Phase] = []
        self._stack: List[str] = []
        self._log = open(log_file, "a") if log_file else None

    @contextlib.contextmanager
    def phase(self, name: str, **meta):
        full = "/".join(self._stack + [name])
        p = Phase(name=full, start=time.time(), meta=meta)
        self._stack.append(name)
        try:
            yield p
        finally:
            self._stack.pop()
            p.elapsed = time.time() - p.start
            self.phases.append(p)
            if self.verbose:
                print(f"[gauss_tpu_torch] {full}: {p.elapsed:.3f}s "
                      + (json.dumps(meta) if meta else ""),
                      file=sys.stderr, flush=True)
            if self._log:
                self._log.write(json.dumps(
                    {"phase": full, "elapsed": p.elapsed, **meta}) + "\n")
                self._log.flush()

    def report(self) -> Dict[str, float]:
        agg: Dict[str, float] = {}
        for p in self.phases:
            agg[p.name] = agg.get(p.name, 0.0) + p.elapsed
        return agg


NULL_TRACER = Tracer()


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace of the calls inside when
    GAUSS_TPU_TRACE (or log_dir) names a directory: one Chrome trace file
    (``trace_<pid>_<ms>.json``, for chrome://tracing or Perfetto) is
    written there on exit.  CPU activities always, CUDA activities too
    when a card is present.  No-op otherwise."""
    log_dir = log_dir or os.environ.get("GAUSS_TPU_TRACE")
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))

"""gauss_tpu_torch's multi-host layer (parallel/distributed.py) against
gauss_tpu's, and a two-process run under torchrun's environment.

Two processes of ``python -m gauss_tpu_torch impute-genome --multihost``
on the CPU (gloo on a free localhost port) each own a contiguous block of
the windows and a ledger of their own; process 0 merges.  The merged
output must be the single-process run's (rtol 1e-12: the same windows
through the same float64 host path), as tests/test_multihost.py holds
gauss_tpu's.
"""

import json
import os
import socket
import subprocess
import sys
import warnings

import numpy as np
import pandas as pd

from gauss_tpu.parallel import distributed as j_dist
from gauss_tpu_torch import cli as t_cli
from gauss_tpu_torch.parallel import distributed as t_dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_host_window_ranges_match_gauss_tpu():
    for start, end, w in [(1_000_000, 3_399_999, 600_000), (1, 1, 10),
                          (5, 1_004, 100), (0, 999, 1_000), (7, 7_000, 13)]:
        for num in (1, 2, 3, 7, 64):
            got = [t_dist.host_window_ranges(start, end, w, num, h)
                   for h in range(num)]
            assert got == [j_dist.host_window_ranges(start, end, w, num, h)
                           for h in range(num)]
            spans = sorted(r for r in got if r[0] <= r[1])
            assert spans[0][0] == start and spans[-1][1] == end
            assert all(b[0] == a[1] + 1 for a, b in zip(spans, spans[1:]))


def _fake_run_dir(root):
    """Two hosts' ledgers: host000 done chunks (one shard missing, one
    chunk failed), host001 done chunks written out of order, plus a host
    directory without a manifest."""
    rng = np.random.default_rng(0)
    layout = {"host000": [(22, 1, 100, "done"), (22, 101, 200, "failed"),
                          (22, 201, 300, "done"), (22, 301, 400, "done")],
              "host001": [(22, 601, 700, "done"), (22, 401, 500, "done")],
              "host002": None}
    for host, chunks in layout.items():
        os.makedirs(root / host / "results")
        if chunks is None:
            continue
        man = {"chunks": []}
        for chrom, lo, hi, status in chunks:
            man["chunks"].append(dict(chrom=chrom, start_bp=lo, end_bp=hi,
                                      status=status))
            key = f"{chrom}_{lo}_{hi}"
            if status == "done" and (host, lo) != ("host000", 201):
                pd.DataFrame({"bp": np.arange(lo, hi, 10),
                              "z": rng.standard_normal(len(range(lo, hi,
                                                                 10)))}
                             ).to_parquet(root / host / "results"
                                          / f"{key}.parquet")
        (root / host / "manifest.json").write_text(json.dumps(man))


def test_collect_multihost_matches_gauss_tpu(tmp_path):
    _fake_run_dir(tmp_path)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        got = t_dist.collect_multihost(str(tmp_path))
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        ref = j_dist.collect_multihost(str(tmp_path))
    pd.testing.assert_frame_equal(got, ref)
    assert got["bp"].is_monotonic_increasing and len(got) == 40
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    assert len(wt) == 1 and "201_300" in str(wt[0].message)
    assert t_dist.collect_multihost(str(tmp_path / "host002")).empty


def test_single_process_defaults(monkeypatch, tmp_path):
    for k in t_dist.ENV:
        monkeypatch.delenv(k, raising=False)
    t_dist.initialize()                      # no torchrun env: a no-op
    assert t_dist.process_info() == (1, 0)
    t_dist.barrier("single")                 # one process: returns
    assert t_dist.host_run_dir(str(tmp_path)) == str(tmp_path / "host000")
    assert t_dist.host_run_dir("r", 12) == os.path.join("r", "host012")
    m = t_dist.global_mesh(device_type="cpu")
    assert m.shape == {"window": 1, "subject": 1}
    assert t_dist.global_mesh(2, 3, device_type="cpu").shape == {
        "window": 2, "subject": 3}


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _torchrun_env(rank: int, port: int, world: int = 2) -> dict:
    env = dict(os.environ)
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank),
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    return env


def _launch(argv_of_rank, timeout=120):
    """Start one process per rank with torchrun's environment on a free
    port; wait for all; return [(returncode, stdout, stderr)]."""
    port = _free_port()
    procs = [subprocess.Popen(argv_of_rank(r), env=_torchrun_env(r, port),
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(p.returncode, o, e) for p, (o, e) in zip(procs, outs)]


def _genome_argv(synpanel, gwas_input, tmp_path):
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    window = (hi - lo) // 4 + 1          # 4 windows, 2 per host
    wgt = tmp_path / "wgt.tsv"
    pd.DataFrame({"pop": ["AAA", "BBB"], "wgt": [0.5, 0.5]}).to_csv(
        wgt, sep="\t", index=False)
    return ["impute-genome", "--chr", "22", "--start-bp", str(lo),
            "--end-bp", str(hi), "--pop-wgt-file", str(wgt),
            "--input-file", path, "--window-bp", str(window),
            "--wing-size", str(window), "--chunk-bp", str(window),
            "--host-linalg", "--device", "cpu",
            "--reference-index-file", synpanel.files.index_file,
            "--reference-data-file", synpanel.files.data_file,
            "--reference-pop-desc-file", synpanel.files.pop_desc_file]


def test_two_process_cpu_matches_single(synpanel, gwas_input, tmp_path):
    base = _genome_argv(synpanel, gwas_input, tmp_path)
    ref_out = tmp_path / "ref.tsv"
    t_cli.main(base + ["--run-dir", str(tmp_path / "run1"),
                       "-o", str(ref_out)])
    ref = pd.read_csv(ref_out, sep="\t")

    mh_out, run_dir = tmp_path / "mh.tsv", tmp_path / "run_mh"
    res = _launch(lambda r: [sys.executable, "-m", "gauss_tpu_torch"] + base
                  + ["--multihost", "--run-dir", str(run_dir),
                     "-o", str(mh_out)])
    for rc, _, err in res:
        assert rc == 0, err[-2000:]
    got = pd.read_csv(mh_out, sep="\t")
    assert len(got) == len(ref) > 0
    pd.testing.assert_frame_equal(got, ref, check_exact=False, rtol=1e-12,
                                  atol=1e-12)
    hosts = sorted(d for d in os.listdir(run_dir) if d.startswith("host"))
    assert hosts == ["host000", "host001"]
    keys = []
    for h in hosts:
        man = json.loads((run_dir / h / "manifest.json").read_text())
        assert [c["status"] for c in man["chunks"]] == ["done", "done"]
        keys.append({(c["start_bp"], c["end_bp"]) for c in man["chunks"]})
    assert not keys[0] & keys[1]                    # disjoint ledgers
    ranges = [t_dist.host_window_ranges(
        int(base[4]), int(base[6]), int(base[12]), 2, h) for h in range(2)]
    for k, (lo, hi) in zip(keys, ranges):
        assert min(a for a, _ in k) == lo and max(b for _, b in k) == hi


FAILING_HOST = r"""
import sys
import pandas as pd
from gauss_tpu_torch.config import PanelFiles
from gauss_tpu_torch.io import readers
from gauss_tpu_torch.models.genome import GenomeEngine, PanelStore
from gauss_tpu_torch.models.runner import GenomeRunner
from gauss_tpu_torch.parallel import distributed

run_dir, zfile = sys.argv[1:3]
lo, hi, window = (int(a) for a in sys.argv[3:6])
files = PanelFiles(*sys.argv[6:9])
distributed.initialize()
num, pid = distributed.process_info()
store = PanelStore.from_bgzf(files, chrom=22)
inp = readers.read_input_z(zfile, chrom=22, start_bp=lo, end_bp=hi,
                           wing_size=window)

def make_runner(d, a, b):
    r = GenomeRunner(d, GenomeEngine(store, "cpu"), inp,
                     {"AAA": 0.5, "BBB": 0.5}, window_bp=window,
                     wing_size=window, chunk_bp=window)
    if pid == 1:
        def fail(cs=None):
            raise RuntimeError("synthetic host failure")
        r._prepared = fail
    return r

try:
    df = distributed.run_genome_multihost(make_runner, 22, lo, hi, window,
                                          run_dir)
    print(f"host {pid} of {num}: merged {0 if df is None else len(df)} rows")
finally:
    distributed.shutdown()
"""


def test_all_failed_host_raises_after_the_barrier(synpanel, gwas_input,
                                                  tmp_path):
    """Host 1's chunks all fail: both processes pass the barrier, host 0
    merges its own rows and exits 0, host 1 raises."""
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    window = (hi - lo) // 4 + 1
    args = [str(tmp_path / "run"), gwas_input[0], str(lo), str(hi),
            str(window), synpanel.files.index_file,
            synpanel.files.data_file, synpanel.files.pop_desc_file]
    (rc0, out0, err0), (rc1, out1, err1) = _launch(
        lambda r: [sys.executable, "-c", FAILING_HOST] + args)
    assert rc0 == 0, err0[-2000:]
    assert out0.startswith("host 0 of 2: merged ") and \
        int(out0.split()[-2]) > 0
    assert rc1 != 0 and "merged" not in out1
    assert "host 1: every chunk failed" in err1
    assert "synthetic host failure" in err1
    man = json.loads((tmp_path / "run" / "host001" / "manifest.json"
                      ).read_text())
    assert {c["status"] for c in man["chunks"]} == {"failed"}

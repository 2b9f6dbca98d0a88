"""gauss_tpu_torch/utils/timing.py against gauss_tpu's: the same phases,
nesting, report and log lines; device_trace is a no-op when unset and
writes a torch.profiler Chrome trace when set."""

import glob
import json
import os

import pytest
import torch

from gauss_tpu.utils import timing as j_timing
from gauss_tpu_torch.utils import goldens, timing
from gauss_tpu.utils import goldens as j_goldens


def _drive(mod, log_file, fail=False):
    tr = mod.Tracer(verbose=True, log_file=log_file)
    with tr.phase("outer", rows=3):
        with tr.phase("inner", key="a", prefetched=False):
            pass
        with tr.phase("inner", key="b", prefetched=True):
            pass
    if fail:
        with pytest.raises(KeyError):
            with tr.phase("broken"):
                raise KeyError("x")
    return tr


@pytest.mark.parametrize("fail", [False, True])
def test_tracer_matches_gauss_tpu(tmp_path, capsys, fail):
    tj = _drive(j_timing, str(tmp_path / "j.jsonl"), fail)
    err_j = capsys.readouterr().err
    tt = _drive(timing, str(tmp_path / "t.jsonl"), fail)
    err_t = capsys.readouterr().err
    assert [(p.name, p.meta) for p in tt.phases] == \
        [(p.name, p.meta) for p in tj.phases]
    assert [p.name for p in tt.phases][:3] == ["outer/inner", "outer/inner",
                                               "outer"]
    assert all(p.elapsed >= 0 and p.start > 0 for p in tt.phases)
    assert set(tt.report()) == set(tj.report())
    assert tt._stack == []
    # log lines: the same keys and phases, one JSON object per phase
    lines = [[json.loads(x) for x in open(tmp_path / f).read().splitlines()]
             for f in ("j.jsonl", "t.jsonl")]
    strip = lambda rows: [{k: v for k, v in r.items() if k != "elapsed"}
                          for r in rows]
    assert strip(lines[1]) == strip(lines[0])
    assert all("elapsed" in r for r in lines[1])
    # the verbose lines differ in the package's prefix only
    shape = lambda err, tag: [x.split(":")[0].replace(tag, "[]")
                              for x in err.splitlines()]
    assert shape(err_t, "[gauss_tpu_torch]") == shape(err_j, "[gauss_tpu]")
    assert all(x.startswith("[gauss_tpu_torch] ")
               for x in err_t.splitlines())


def test_null_tracer_and_append(tmp_path):
    assert timing.NULL_TRACER.verbose is False
    assert timing.NULL_TRACER._log is None
    log = str(tmp_path / "log.jsonl")
    for _ in range(2):                 # a second tracer appends
        with timing.Tracer(log_file=log).phase("p"):
            pass
    assert len(open(log).read().splitlines()) == 2
    p = timing.Phase(name="x", start=1.0)
    assert p.elapsed == 0.0 and p.meta == {}


def test_device_trace_noop_when_unset(tmp_path, monkeypatch):
    monkeypatch.delenv("GAUSS_TPU_TRACE", raising=False)
    monkeypatch.chdir(tmp_path)
    with timing.device_trace():
        torch.ones(4).sum()
    with timing.device_trace(None):
        pass
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_device_trace_writes_a_chrome_trace(tmp_path, monkeypatch, how):
    d = tmp_path / "traces" / how
    monkeypatch.delenv("GAUSS_TPU_TRACE", raising=False)
    if how == "environment":
        monkeypatch.setenv("GAUSS_TPU_TRACE", str(d))
    with timing.device_trace(str(d) if how == "argument" else None):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = glob.glob(str(d / "trace_*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    # an exception inside passes through; no trace file is written
    with pytest.raises(ZeroDivisionError):
        with timing.device_trace(str(d / "failed")):
            1 / 0
    assert glob.glob(str(d / "failed" / "*.json")) == []


def test_goldens_are_gauss_tpus(monkeypatch, tmp_path):
    """utils/goldens.py is carried over value for value; its directories
    come from the environment alone."""
    names = [n for n in dir(j_goldens) if n.isupper()]
    assert len(names) >= 13
    for n in names:
        assert getattr(goldens, n) == getattr(j_goldens, n), n
    monkeypatch.delenv("GAUSS_33KG_DIR", raising=False)
    monkeypatch.delenv("GAUSS_REFERENCE_DIR", raising=False)
    assert goldens.panel_dir() is None and goldens.reference_dir() is None
    (tmp_path / "33kg_index.gz").write_bytes(b"")
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "PGC2_3Mb.txt").write_text("")
    monkeypatch.setenv("GAUSS_33KG_DIR", str(tmp_path))
    monkeypatch.setenv("GAUSS_REFERENCE_DIR", str(tmp_path))
    assert goldens.panel_dir() == j_goldens.panel_dir() == str(tmp_path)
    assert goldens.reference_dir() == j_goldens.reference_dir() \
        == str(tmp_path)

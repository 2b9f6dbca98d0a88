"""gauss_tpu_torch's checkpointed genome runner against gauss_tpu's.

Same panel, input and chunking through both packages' ``GenomeRunner``
(the cases of tests/test_runner.py): the JAX side as its own resident
tests run it on the CPU (``region_mode="resident"``, interpret-mode
Pallas, ``snp_bucket=64``; its mesh cases on the conftest's 8 virtual
devices), the port on ``device="cpu"`` through the kernels' plain
versions, its mesh cases on a repeated CPU.

Compared: chunk keys, statuses, ``n_rows``, ``n_imputed`` and errors of
every ledger entry (every field but ``elapsed`` and ``updated``, which
are wall-clock), the parquet rows and the ``collect_ld`` matrices.
Tolerances are those the port's region tests use on the same kind of
panel: imputed z rtol 2e-4 / atol 1e-4 and info rtol 2e-4 / atol 2e-5
(tests/test_torch_genome.py), qcat_t 2e-4 and qcat_chisq 5e-4
(tests/test_torch_qcat.py), LD 2e-4 plus the int16 quantization step
(tests/test_torch_ld.py), gene statistics rtol 1e-10
(tests/test_torch_jepeg.py); measured rows bit-equal.
"""

import json
import os
import time

import numpy as np
import pandas as pd
import pytest
import torch

from gauss_tpu.config import PanelFiles as JFiles
from gauss_tpu.io import readers as j_readers
from gauss_tpu.models.genome import GenomeEngine as JEngine
from gauss_tpu.models.genome import PanelStore as JStore
from gauss_tpu.models.runner import GenomeRunner as JRunner
from gauss_tpu.utils.testing import (make_annotation, make_gwas_input,
                                     make_synthetic_panel)
from gauss_tpu_torch.config import PanelFiles as TFiles
from gauss_tpu_torch.models.genome import GenomeEngine as TEngine
from gauss_tpu_torch.models.genome import PanelStore as TStore
from gauss_tpu_torch.models.runner import GenomeRunner as TRunner
from gauss_tpu_torch.ops.window_kernel import LD_I16_MAX_ERR
from gauss_tpu_torch.utils.timing import Tracer

LO, HI = 1_000_000, 2_800_000
KW = dict(window_bp=600_000, wing_size=200_000, chunk_bp=600_000)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_runner_panel")
    p = make_synthetic_panel(str(d), n_snps=900, bp_start=LO,
                             bp_step=2_000, seed=11)
    zin = str(d / "zin.txt")
    make_gwas_input(p, zin, measured_frac=0.5, seed=12)
    f = (p.files.index_file, p.files.data_file, p.files.pop_desc_file)
    inp = j_readers.read_input_z(zin, chrom=22, start_bp=LO, end_bp=HI,
                                 wing_size=200_000)
    pop_wgt = {pop: 1.0 / len(p.desc.pops) for pop in p.desc.pops}
    apath = str(d / "annot.txt")
    make_annotation(p, apath)
    return dict(jstore=JStore.from_bgzf(JFiles(*f), chrom=22),
                tstore=TStore.from_bgzf(TFiles(*f), chrom=22),
                jfiles=JFiles(*f), tfiles=TFiles(*f), inp=inp,
                pop_wgt=pop_wgt, annot=j_readers.read_annotation(apath))


def _jax(setup, run_dir, pop_wgt="mix", store=True, **kw):
    eng = JEngine(setup["jstore"] if store else None, snp_bucket=64,
                  device_linalg=True, region_mode="resident")
    wgt = setup["pop_wgt"] if pop_wgt == "mix" else pop_wgt
    return JRunner(str(run_dir), eng, setup["inp"], wgt, **{**KW, **kw})


def _torch(setup, run_dir, pop_wgt="mix", store=True, device="cpu", **kw):
    eng = TEngine(setup["tstore"] if store else None, device,
                  device_linalg=True)
    wgt = setup["pop_wgt"] if pop_wgt == "mix" else pop_wgt
    return TRunner(str(run_dir), eng, setup["inp"], wgt, **{**KW, **kw})


def _planned(runner):
    runner.plan(chrom=22, start_bp=LO, end_bp=HI)
    return runner


def _ledger(runner, first_line_of_error=True):
    """Every ledger field but the wall-clock ones."""
    out = {}
    for key, c in runner.chunks.items():
        err = c.error
        if err is not None and first_line_of_error:
            err = err.splitlines()[0]      # the traceback names the package
        out[key] = (c.chrom, c.start_bp, c.end_bp, c.status, c.n_rows,
                    c.n_imputed, err)
    return out


def _assert_impute_close(df_t, df_j):
    assert len(df_t) == len(df_j) > 0
    assert list(df_t.columns) == list(df_j.columns)
    for col in ("rsid", "chr", "bp", "a1", "a2", "type"):
        np.testing.assert_array_equal(df_t[col].to_numpy(),
                                      df_j[col].to_numpy())
    imp = df_j["type"].to_numpy() == 0
    assert imp.any() and (~imp).any()
    for col in ("z", "info", "pval"):
        np.testing.assert_array_equal(df_t[col].to_numpy()[~imp],
                                      df_j[col].to_numpy()[~imp])
    np.testing.assert_allclose(df_t["z"].to_numpy()[imp],
                               df_j["z"].to_numpy()[imp],
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(df_t["info"].to_numpy()[imp],
                               df_j["info"].to_numpy()[imp],
                               rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def reference_run(setup, tmp_path_factory):
    """gauss_tpu's runner over the span, once: (runner, stats, frame)."""
    r = _planned(_jax(setup, tmp_path_factory.mktemp("jax_run")))
    stats = r.run()
    return r, stats, r.collect()


@pytest.fixture(scope="module")
def port_run(setup, tmp_path_factory):
    r = _planned(_torch(setup, tmp_path_factory.mktemp("torch_run")))
    stats = r.run()
    return r, stats, r.collect()


def test_run_and_collect(reference_run, port_run):
    rj, stats_j, df_j = reference_run
    rt, stats_t, df_t = port_run
    assert stats_t == stats_j
    assert stats_t["failed"] == 0 and stats_t["done"] >= 2
    assert _ledger(rt) == _ledger(rj)
    _assert_impute_close(df_t, df_j)
    man_t = json.load(open(os.path.join(rt.run_dir, "manifest.json")))
    man_j = json.load(open(os.path.join(rj.run_dir, "manifest.json")))
    assert all(c["status"] == "done" for c in man_t["chunks"])
    assert set(man_t) == set(man_j)
    for k in set(man_t) - {"updated", "chunks"}:
        assert man_t[k] == man_j[k]
    assert [set(c) for c in man_t["chunks"]] == \
        [set(c) for c in man_j["chunks"]]
    assert sorted(os.listdir(os.path.join(rt.run_dir, "results"))) == \
        sorted(os.listdir(os.path.join(rj.run_dir, "results")))
    assert rt.status() == rj.status()


def test_resume_skips_done(setup, reference_run, port_run):
    rj, _, df_j = reference_run
    rt, _, df_t = port_run
    # fresh runners over the same dirs resume: everything skipped
    stats_j = _jax(setup, rj.run_dir).run(resume=True)
    r2 = _torch(setup, rt.run_dir)
    stats_t = r2.run(resume=True)
    assert stats_t == stats_j
    assert stats_t["done"] == 0 and stats_t["skipped"] >= 2
    pd.testing.assert_frame_equal(r2.collect(), df_t)


def _flaky(Runner, fail_call, handle=None):
    """Runner._prepared whose run fails once, at its ``fail_call``-th
    dispatch: by raising, or by returning ``handle``."""
    real = Runner._prepared
    calls = {"n": 0}

    def flaky(self, cs=None):
        run = real(self, cs)
        orig = run.impute_region_async

        def wrapped(start_bp, end_bp, **kw):
            calls["n"] += 1
            if calls["n"] == fail_call and not calls.get("healed"):
                calls["healed"] = True
                if handle is not None:
                    return handle
                raise RuntimeError("injected chunk failure")
            return orig(start_bp, end_bp, **kw)

        run.impute_region_async = wrapped
        return run

    return real, flaky


def _run_with_failure(monkeypatch, Runner, runner, fail_call, handle=None):
    real, flaky = _flaky(Runner, fail_call, handle)
    monkeypatch.setattr(Runner, "_prepared", flaky)
    stats = runner.run()
    monkeypatch.setattr(Runner, "_prepared", real)
    return stats


def test_failure_recorded_then_resumed(tmp_path, setup, monkeypatch,
                                       reference_run):
    rj = _planned(_jax(setup, tmp_path / "j"))
    rt = _planned(_torch(setup, tmp_path / "t"))
    stats_j = _run_with_failure(monkeypatch, JRunner, rj, 2)
    stats_t = _run_with_failure(monkeypatch, TRunner, rt, 2)
    assert stats_t == stats_j and stats_t["failed"] == 1
    assert rt.status() == rj.status() and rt.status()["failed"] == 1
    assert _ledger(rt) == _ledger(rj)
    failed = [c for c in rt.chunks.values() if c.status == "failed"]
    assert "injected chunk failure" in failed[0].error

    # resume: the failed chunk alone is retried and completes
    stats_j2, stats_t2 = rj.run(resume=True), rt.run(resume=True)
    assert stats_t2 == stats_j2
    assert stats_t2["failed"] == 0 and stats_t2["done"] == 1
    assert _ledger(rt) == _ledger(rj) == _ledger(reference_run[0])
    _assert_impute_close(rt.collect(), reference_run[2])


def test_restart_retries_failed_chunks(tmp_path, setup, monkeypatch,
                                       reference_run, port_run):
    """resume=False recomputes everything, chunks marked failed
    included."""
    rt = _planned(_torch(setup, tmp_path / "t"))
    assert _run_with_failure(monkeypatch, TRunner, rt, 2)["failed"] == 1
    stats = rt.run(resume=False)
    assert stats == {"done": len(rt.chunks), "failed": 0, "skipped": 0}
    assert rt.status() == reference_run[0].status()
    assert _ledger(rt) == _ledger(reference_run[0])
    pd.testing.assert_frame_equal(rt.collect(), port_run[2])


def test_manifest_param_mismatch_raises(setup, reference_run, port_run):
    def message(make, run_dir, **kw):
        with pytest.raises(ValueError, match="different") as ei:
            make(setup, run_dir, **kw)
        return str(ei.value).replace(str(run_dir), "DIR")

    dj, dt = reference_run[0].run_dir, port_run[0].run_dir
    for kw, word in ((dict(analysis="qcat"), "analysis"),
                     (dict(window_bp=500_000), "window_bp"),
                     (dict(af1_cutoff=0.02), "af1_cutoff")):
        got = message(_torch, dt, **kw)
        assert word in got
        assert got == message(_jax, dj, **kw)


def test_manifest_loads_in_the_other_package(setup, reference_run,
                                             port_run):
    """A run directory written by one package resumes and collects in
    the other."""
    rj, _, df_j = reference_run
    rt, _, df_t = port_run
    over_j = _torch(setup, rj.run_dir)
    assert _ledger(over_j) == _ledger(rj)
    assert over_j.run(resume=True)["skipped"] == len(rj.chunks)
    pd.testing.assert_frame_equal(over_j.collect(), df_j)
    over_t = _jax(setup, rt.run_dir)
    assert _ledger(over_t) == _ledger(rt)
    assert over_t.run(resume=True)["skipped"] == len(rt.chunks)
    pd.testing.assert_frame_equal(over_t.collect(), df_t)


def test_streaming_matches_resident(tmp_path, setup, reference_run,
                                    port_run):
    """Per-chunk panel decode (streaming) == the resident-panel run."""
    r = _planned(_torch(setup, tmp_path / "s", store=False,
                        panel_files=setup["tfiles"]))
    stats = r.run()
    assert stats == port_run[1]
    assert _ledger(r) == _ledger(reference_run[0])
    got, ref = r.collect(), port_run[2]
    # a chunk's own panel range has other store rows, the same dosages
    pd.testing.assert_frame_equal(got, ref, rtol=0, atol=0)
    _assert_impute_close(got, reference_run[2])
    with pytest.raises(ValueError, match="streaming"):
        _torch(setup, tmp_path / "s2", store=False,
               panel_files=setup["tfiles"]).plan(chrom=22)


def _assert_qcat_close(got, ref):
    assert len(got) == len(ref) > 0
    assert list(got.columns) == list(ref.columns)
    for col in ("rsid", "bp", "type", "qcat_m"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    np.testing.assert_allclose(got["qcat_t"], ref["qcat_t"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got["qcat_chisq"], ref["qcat_chisq"],
                               rtol=5e-4, atol=5e-4)


def test_qcat_analysis_runner(tmp_path, setup):
    rj = _planned(_jax(setup, tmp_path / "j", analysis="qcat"))
    rt = _planned(_torch(setup, tmp_path / "t", analysis="qcat"))
    stats_j, stats_t = rj.run(), rt.run()
    assert stats_t == stats_j
    assert stats_t["failed"] == 0 and stats_t["done"] >= 2
    assert _ledger(rt) == _ledger(rj)
    _assert_qcat_close(rt.collect(), rj.collect())


def test_dist_homog_analysis_runner(tmp_path, setup):
    """analysis='impute' with study_pop runs the homogeneous dist path
    through the ledger, as gauss_tpu's runner and as an unchunked
    prepare_homog run."""
    kw = dict(pop_wgt=None, study_pop="EUR")
    rj = _planned(_jax(setup, tmp_path / "j", **kw))
    rt = _planned(_torch(setup, tmp_path / "t", **kw))
    stats_j, stats_t = rj.run(), rt.run()
    assert stats_t == stats_j and stats_t["failed"] == 0
    assert _ledger(rt) == _ledger(rj)
    got = rt.collect()
    assert "af1ref" in got.columns
    _assert_impute_close(got, rj.collect())
    direct = rt.engine.prepare_homog(setup["inp"], "EUR").impute_region(
        LO, HI, window_bp=KW["window_bp"], wing_size=KW["wing_size"])
    # a chunk's band heights differ from the whole region's, so the f32
    # solves run at other padded sizes
    _assert_impute_close(got, direct)


def test_ld_analysis_runner(tmp_path, setup):
    """analysis='ld' persists the window matrices; collect_ld gives them
    back as a direct ld_region call and as gauss_tpu's runner does."""
    kw = dict(chunk_bp=1_200_000, analysis="ld")
    rj = _planned(_jax(setup, tmp_path / "j", **kw))
    rt = _planned(_torch(setup, tmp_path / "t", **kw))
    stats_j, stats_t = rj.run(), rt.run()
    assert stats_t == stats_j and stats_t["failed"] == 0
    assert _ledger(rt) == _ledger(rj)
    assert sorted(os.listdir(os.path.join(rt.run_dir, "results"))) == \
        sorted(os.listdir(os.path.join(rj.run_dir, "results")))
    blocks, ref = rt.collect_ld(), rj.collect_ld()
    direct = rt.engine.prepare_mix(setup["inp"], setup["pop_wgt"]
                                   ).ld_region(LO, HI,
                                               window_bp=KW["window_bp"])
    assert len(blocks) == len(ref) == len(direct) > 0
    for b, r, d in zip(blocks, ref, direct):
        pd.testing.assert_frame_equal(
            b["snplist"].drop(columns="fetch"),
            r["snplist"].drop(columns="fetch"))
        assert set(b["snplist"]["fetch"]) == set(r["snplist"]["fetch"]) \
            == {"i16tri"}
        assert list(b["snplist"]["rsid"]) == list(d["snplist"]["rsid"])
        np.testing.assert_allclose(b["cormat"], d["cormat"], rtol=0, atol=0)
        # both sides quantize to int16 steps
        np.testing.assert_allclose(b["cormat"], r["cormat"], rtol=2e-4,
                                   atol=2e-4 + 2 * LD_I16_MAX_ERR)
    with pytest.raises(ValueError, match="collect_ld"):
        _torch(setup, tmp_path / "imp").collect_ld()


def test_jepeg_analysis_runner(tmp_path, setup):
    """analysis='jepeg' partitions the genes across chunks; the union is
    the unchunked gene path's and gauss_tpu's runner's."""
    kw = dict(analysis="jepeg", annot_df=setup["annot"])
    rj = _planned(_jax(setup, tmp_path / "j", **kw))
    rt = _planned(_torch(setup, tmp_path / "t", **kw))
    stats_j, stats_t = rj.run(), rt.run()
    assert stats_t == stats_j and stats_t["failed"] == 0
    assert _ledger(rt) == _ledger(rj)
    key = lambda df: df.sort_values("geneid").reset_index(drop=True)
    got, ref = key(rt.collect()), key(rj.collect())
    direct = key(rt.engine.prepare_genes(
        setup["inp"], setup["annot"], pop_wgt=setup["pop_wgt"]
    ).jepeg_region(LO, HI))
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) == len(direct) > 0
    for col in got.columns:
        a, b = got[col].to_numpy(), ref[col].to_numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got["chisq"], direct["chisq"], rtol=0,
                               atol=0)


def _mesh_runner(setup, run_dir, shape=(2, 4), **kw):
    from gauss_tpu_torch.parallel.mesh import make_mesh
    n = shape[0] * shape[1]
    eng = TEngine(setup["tstore"], mesh=make_mesh(*shape,
                                                  devices=["cpu"] * n))
    return _planned(TRunner(str(run_dir), eng, setup["inp"],
                            setup["pop_wgt"], **{**KW, **kw}))


def test_runner_on_mesh_matches_single_device(tmp_path, setup, port_run):
    """The checkpointed run over a (2 x 4) mesh of a repeated CPU: the
    port's one-device run (gauss_tpu's bar for its own mesh runner, z rtol
    2e-5 / atol 2e-5) and gauss_tpu's runner on its 2x4 mesh (the f32
    region bar)."""
    import jax
    r = _mesh_runner(setup, tmp_path / "mesh")
    stats = r.run()
    assert stats == port_run[1] and stats["failed"] == 0
    assert _ledger(r) == _ledger(port_run[0])
    df_m, df_1 = r.collect(), port_run[2]
    assert len(df_m) == len(df_1) > 0
    for col in ("z", "info"):
        np.testing.assert_allclose(df_m[col].to_numpy(), df_1[col].to_numpy(),
                                   rtol=2e-5, atol=2e-5)
    if len(jax.devices()) < 8:
        return
    from gauss_tpu.parallel.mesh import make_mesh
    rj = _planned(JRunner(str(tmp_path / "jmesh"), JEngine(
        setup["jstore"], snp_bucket=64, mesh=make_mesh(2, 4)), setup["inp"],
        setup["pop_wgt"], **KW))
    assert rj.run() == stats
    _assert_impute_close(df_m, rj.collect())


def test_jepeg_runner_on_mesh(tmp_path, setup):
    """analysis='jepeg' over a (2 x 4) mesh: the one-device run's genes
    (exact partials over the shards, rtol 1e-12)."""
    kw = dict(analysis="jepeg", annot_df=setup["annot"], chunk_bp=900_000)
    rm = _mesh_runner(setup, tmp_path / "mesh", **kw)
    r1 = _planned(_torch(setup, tmp_path / "one", **kw))
    assert rm.run() == r1.run()
    key = lambda df: df.sort_values("geneid").reset_index(drop=True)
    got, ref = key(rm.collect()), key(r1.collect())
    assert list(got.columns) == list(ref.columns) and len(got) > 0
    for col in got.columns:
        a, b = got[col].to_numpy(), ref[col].to_numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-300,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(a, b)


def test_runner_rejects_bad_pop_mode(tmp_path, setup):
    for make in (_jax, _torch):
        with pytest.raises(ValueError, match="exactly one"):
            make(setup, tmp_path / "x", study_pop="EUR")
        with pytest.raises(ValueError, match="exactly one"):
            make(setup, tmp_path / "y", pop_wgt=None)
        with pytest.raises(ValueError, match="annot_df"):
            make(setup, tmp_path / "z", analysis="jepeg")
        with pytest.raises(ValueError, match="pop_wgt"):
            make(setup, tmp_path / "w", pop_wgt=None, study_pop="EUR",
                 analysis="ld")
        with pytest.raises(ValueError, match="unknown analysis"):
            make(setup, tmp_path / "v", analysis="afmix")


def test_streaming_prefetch_overlaps_decode(tmp_path, setup):
    """In streaming mode chunk N+1's panel decode runs on a worker thread
    while chunk N computes: every decode_chunk phase but the first is
    marked prefetched, and the phases are gauss_tpu's."""
    from gauss_tpu.utils.timing import Tracer as JTracer
    tj, tt = JTracer(), Tracer()
    rj = _planned(_jax(setup, tmp_path / "j", store=False,
                       panel_files=setup["jfiles"], tracer=tj))
    rt = _planned(_torch(setup, tmp_path / "t", store=False,
                         panel_files=setup["tfiles"], tracer=tt))
    stats_j, stats_t = rj.run(), rt.run()
    assert stats_t == stats_j
    assert stats_t["failed"] == 0 and stats_t["done"] >= 2
    decodes = [p for p in tt.phases if p.name.endswith("decode_chunk")]
    assert len(decodes) == stats_t["done"]
    assert decodes[0].meta["prefetched"] is False   # nothing to overlap yet
    assert all(p.meta["prefetched"] for p in decodes[1:])
    assert rt._prefetch == {}                       # cleaned up
    assert [(p.name, p.meta) for p in tt.phases] == \
        [(p.name, p.meta) for p in tj.phases]


class _BoomHandle:
    def result(self):
        raise RuntimeError("injected fetch failure")


def test_fetch_failure_attributed_to_its_chunk(tmp_path, setup,
                                               monkeypatch):
    """A failure that surfaces when a chunk's handle is fetched is
    recorded against that chunk, as in gauss_tpu's pipelined runner (the
    port fetches each chunk before it prepares the next)."""
    rj = _planned(_jax(setup, tmp_path / "j"))
    rt = _planned(_torch(setup, tmp_path / "t"))
    stats_j = _run_with_failure(monkeypatch, JRunner, rj, 1, _BoomHandle())
    stats_t = _run_with_failure(monkeypatch, TRunner, rt, 1, _BoomHandle())
    assert stats_t == stats_j and stats_t["failed"] == 1
    assert _ledger(rt) == _ledger(rj)
    failed = [c for c in rt.chunks.values() if c.status == "failed"]
    assert len(failed) == 1
    assert failed[0].start_bp == LO          # the FIRST chunk's handle
    assert "injected fetch failure" in failed[0].error
    assert sum(c.status == "done" for c in rt.chunks.values()) \
        == len(rt.chunks) - 1


@pytest.mark.parametrize("fail_call,handle", [(2, None),
                                              (1, _BoomHandle())])
def test_max_failures_stops_the_run(tmp_path, setup, monkeypatch,
                                    fail_call, handle):
    """With max_failures=1 the first failure re-raises, at dispatch or at
    fetch, after it was recorded against its own chunk."""
    rt = _planned(_torch(setup, tmp_path / "t"))
    real, flaky = _flaky(TRunner, fail_call, handle)
    monkeypatch.setattr(TRunner, "_prepared", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        rt.run(max_failures=1)
    monkeypatch.setattr(TRunner, "_prepared", real)
    keys = list(rt.chunks)
    failed = [k for k in keys if rt.chunks[k].status == "failed"]
    assert failed == [keys[fail_call - 1]]
    # what the manifest holds is what a resume starts from
    again = _torch(setup, tmp_path / "t")
    assert _ledger(again, False) == _ledger(rt, False)
    stats = again.run(resume=True)
    assert stats["failed"] == 0 and again.status()["done"] == len(keys)


def test_elapsed_is_the_chunks_own_time(tmp_path, setup, monkeypatch):
    """A chunk's elapsed is its own preparation, kernels, fetch and
    write: chunk 3's preparation (slowed here) is not chunk 2's, as it is
    in gauss_tpu's pipelined runner, which fetches chunk 2 only after
    chunk 3 was dispatched.  (Chunk 1 carries the run's one join and is
    left out.)  The delay is a jump of the runner's clock, not a sleep,
    so a loaded machine cannot blur the two."""
    from gauss_tpu_torch.models import runner as runner_mod
    delay = 1000.0
    rt = _planned(_torch(setup, tmp_path / "t"))
    keys = list(rt.chunks)
    assert len(keys) >= 3
    real = TRunner._prepared
    seen = []
    jumped = [0.0]

    class Clock:
        @staticmethod
        def time():
            return time.time() + jumped[0]

    def slow(self, cs=None):
        seen.append(cs.key)
        if cs.key == keys[2]:
            jumped[0] += delay
        return real(self, cs)

    monkeypatch.setattr(runner_mod, "time", Clock)
    monkeypatch.setattr(TRunner, "_prepared", slow)
    assert rt.run()["failed"] == 0
    assert seen == keys
    assert rt.chunks[keys[2]].elapsed >= delay
    for k in keys[1:2] + keys[3:]:
        assert 0 < rt.chunks[k].elapsed < delay / 2, (k, rt.chunks[k])


def test_collect_warns_on_missing_shard(setup, tmp_path):
    """A done chunk whose shard vanished warns; it does not silently
    shorten the output."""
    eng = TEngine(setup["tstore"], "cpu", device_linalg=False)
    r = TRunner(str(tmp_path / "run"), eng, setup["inp"], setup["pop_wgt"],
                window_bp=HI - LO + 1, wing_size=200_000,
                chunk_bp=HI - LO + 1)
    r.plan(22)                        # the store's own bp range
    assert list(r.chunks) == [f"22_{LO}_{int(setup['tstore'].index['bp'].max())}"]
    assert r.run()["done"] == 1
    os.unlink(next(os.path.join(r.run_dir, "results", f)
                   for f in os.listdir(os.path.join(r.run_dir, "results"))
                   if f.endswith(".parquet")))
    with pytest.warns(RuntimeWarning, match="shard is missing"):
        assert len(r.collect()) == 0


@pytest.mark.gpu
def test_runner_on_gpu_matches_cpu(tmp_path, setup, port_run):
    """The runner's impute run on a CUDA engine (K1 and K2 on the card)
    against the CPU engine's on the same chunks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from gauss_tpu_torch.ops import gather, gram
    gram.launches = gather.launches = 0
    r = _planned(_torch(setup, tmp_path / "cuda", device="cuda"))
    stats = r.run()
    assert stats == port_run[1]
    with_rows = sum(c.n_rows > 0 for c in r.chunks.values())
    assert with_rows >= 2
    assert gram.launches >= 2 * with_rows       # mm and um per chunk
    assert gather.launches >= 2 * with_rows     # both halves of its batch
    assert _ledger(r) == _ledger(port_run[0])
    _assert_impute_close(r.collect(), port_run[2])
    before = gram.launches, gather.launches
    assert _torch(setup, tmp_path / "cuda", device="cuda").run()["done"] == 0
    assert (gram.launches, gather.launches) == before

"""gauss_tpu_torch's command line against gauss_tpu's.

Both ``main(argv)`` run on the same files (the cases of tests/test_cli.py)
and their TSV / npz outputs are compared; the port's --mesh runs on a
repeated CPU against its own unsharded runs.  The
per-call subcommands are float64 host paths in both packages: rtol 1e-10.
The genome-scale ones (impute-region --device-linalg, qcat-region,
impute-genome) are f32 device paths: the port runs them with ``--device
cpu`` (the kernels' plain versions), gauss_tpu as its CLI runs on the CPU,
and they meet the bars of tests/test_torch_genome.py and
tests/test_torch_qcat.py (imputed z rtol 2e-4 / atol 1e-4, info rtol 2e-4
/ atol 2e-5, qcat_t 2e-4, qcat_chisq 5e-4; measured rows equal).  Written
TSVs carry 17 significant digits, so a float column read back is the one
written.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from gauss_tpu import cli as j_cli
from gauss_tpu.utils import testing as gtest
from gauss_tpu_torch import cli as t_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def region(synpanel):
    bp = synpanel.index_df["bp"]
    return int(bp.min()), int(bp.max())


def _ref_argv(synpanel):
    return ["--reference-index-file", synpanel.files.index_file,
            "--reference-data-file", synpanel.files.data_file,
            "--reference-pop-desc-file", synpanel.files.pop_desc_file]


def _wgt_file(tmp_path, pops, wgts):
    path = tmp_path / "wgt.tsv"
    pd.DataFrame({"pop": pops, "wgt": wgts}).to_csv(path, sep="\t",
                                                    index=False)
    return str(path)


def _both(argv, tmp_path, name, port_extra=(), **out_flags):
    """Run both CLIs on argv; each writes -o (and the other output flags)
    under its own directory.  Returns the two directories (jax, torch)."""
    dirs = []
    for tag, main, extra in (("j", j_cli.main, []),
                             ("t", t_cli.main, list(port_extra))):
        d = tmp_path / f"{name}_{tag}"
        d.mkdir()
        outs = ["-o", str(d / "out.tsv")]
        for flag, fname in out_flags.items():
            outs += ["--" + flag.replace("_", "-"), str(d / fname)]
        main(argv + extra + outs)
        dirs.append(d)
    return dirs


def _tsv(d, name="out.tsv"):
    return pd.read_csv(d / name, sep="\t")


def _assert_frames_f64(got, ref):
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) > 0
    for col in ref.columns:
        a, b = got[col].to_numpy(), ref[col].to_numpy()
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12,
                                       equal_nan=True)
        else:
            np.testing.assert_array_equal(a, b)


def _assert_impute_close(got, ref):
    assert list(got.columns) == list(ref.columns)
    assert len(got) == len(ref) > 0
    for col in ("rsid", "chr", "bp", "a1", "a2", "type"):
        np.testing.assert_array_equal(got[col].to_numpy(),
                                      ref[col].to_numpy())
    imp = ref["type"].to_numpy() == 0
    assert imp.any() and (~imp).any()
    for col in ("z", "info", "pval"):
        np.testing.assert_array_equal(got[col].to_numpy()[~imp],
                                      ref[col].to_numpy()[~imp])
    np.testing.assert_allclose(got["z"].to_numpy()[imp],
                               ref["z"].to_numpy()[imp], rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["info"].to_numpy()[imp],
                               ref["info"].to_numpy()[imp], rtol=2e-4,
                               atol=2e-5)


def test_cli_distmix(synpanel, gwas_input, region, tmp_path):
    path, _ = gwas_input
    lo, hi = region
    wgt = _wgt_file(tmp_path, ["AAA", "CCC"], [0.6, 0.4])
    dj, dt = _both(["distmix", "--chr", "22",
                    "--start-bp", str(lo + (hi - lo) // 3),
                    "--end-bp", str(lo + 2 * (hi - lo) // 3),
                    "--wing-size", str(hi - lo), "--pop-wgt-file", wgt,
                    "--input-file", path] + _ref_argv(synpanel),
                   tmp_path, "distmix")
    df = _tsv(dt)
    assert {"rsid", "z", "pval", "info", "type"} <= set(df.columns)
    _assert_frames_f64(df, _tsv(dj))


@pytest.mark.parametrize("cmd,pop", [("dist", "study"), ("qcat", "study"),
                                     ("qcatmix", "wgt")])
def test_cli_percall_window_commands(cmd, pop, synpanel, gwas_input, region,
                                     tmp_path):
    path, _ = gwas_input
    lo, hi = region
    popargs = (["--study-pop", "EUR"] if pop == "study" else
               ["--pop-wgt-file",
                _wgt_file(tmp_path, ["AAA", "CCC"], [0.6, 0.4])])
    dj, dt = _both([cmd, "--chr", "22", "--start-bp", str(lo),
                    "--end-bp", str(hi), "--wing-size", str(hi - lo),
                    "--input-file", path] + popargs + _ref_argv(synpanel),
                   tmp_path, cmd)
    _assert_frames_f64(_tsv(dt), _tsv(dj))


def test_cli_compute_ld(synpanel, gwas_input, region, tmp_path):
    path, _ = gwas_input
    lo, hi = region
    wgt = _wgt_file(tmp_path, ["AAA", "EEE"], [0.7, 0.3])
    dj, dt = _both(["computeLD", "--chr", "22", "--start-bp", str(lo),
                    "--end-bp", str(hi), "--pop-wgt-file", wgt,
                    "--input-file", path] + _ref_argv(synpanel),
                   tmp_path, "ld", cormat_out="cormat.tsv")
    snplist = _tsv(dt)
    _assert_frames_f64(snplist, _tsv(dj))
    mat = np.loadtxt(dt / "cormat.tsv")
    assert mat.shape == (len(snplist), len(snplist))
    # %.10g text on both sides
    np.testing.assert_allclose(mat, np.loadtxt(dj / "cormat.tsv"),
                               rtol=1e-9, atol=1e-10)


def test_cli_simulate_ld(synpanel, gwas_input, region, tmp_path):
    path, _ = gwas_input
    lo, hi = region
    wgt = _wgt_file(tmp_path, ["AAA", "EEE"], [0.7, 0.3])
    dj, dt = _both(["simulate-ld", "--chr", "22", "--start-bp", str(lo),
                    "--end-bp", str(hi), "--pop-wgt-file", wgt,
                    "--sim-size", "200", "--seed", "5",
                    "--input-file", path] + _ref_argv(synpanel),
                   tmp_path, "sim", cormat_out="cormat.tsv")
    _assert_frames_f64(_tsv(dt), _tsv(dj))
    np.testing.assert_allclose(np.loadtxt(dt / "cormat.tsv"),
                               np.loadtxt(dj / "cormat.tsv"),
                               rtol=1e-9, atol=1e-10)


def test_cli_fiqt(tmp_path):
    zfile = tmp_path / "z.txt"
    pd.DataFrame({"z": [0.5, -3.2, 7.7]}).to_csv(zfile, sep="\t",
                                                 index=False)
    dj, dt = _both(["fiqt", "--input-file", str(zfile)], tmp_path, "fiqt")
    df = _tsv(dt)
    assert "z_fiqt" in df.columns
    _assert_frames_f64(df, _tsv(dj))


def test_module_runs_fiqt_as_a_subprocess(tmp_path):
    """``python -m gauss_tpu_torch fiqt`` end to end, TSV on stdout."""
    zfile = tmp_path / "z.txt"
    pd.DataFrame({"z": [0.5, -3.2, 7.7]}).to_csv(zfile, sep="\t",
                                                 index=False)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "gauss_tpu_torch", "fiqt",
                          "--input-file", str(zfile)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].split("\t") == ["z", "z_fiqt"] and len(lines) == 4
    ref = tmp_path / "ref.tsv"
    j_cli.main(["fiqt", "--input-file", str(zfile), "-o", str(ref)])
    np.testing.assert_allclose(
        [float(x.split("\t")[1]) for x in lines[1:]],
        pd.read_csv(ref, sep="\t")["z_fiqt"], rtol=1e-10)


def test_cli_import_leaves_jax_out():
    """Importing the CLI, the runner and the new modules imports neither
    jax nor gauss_tpu, and builds nothing."""
    code = ("import sys\n"
            "import gauss_tpu_torch.cli, gauss_tpu_torch.models.runner\n"
            "import gauss_tpu_torch.utils.timing, gauss_tpu_torch.entry\n"
            "import gauss_tpu_torch.utils.goldens\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'gauss_tpu'))\n"
            "assert not bad, bad\n"
            "from gauss_tpu_torch.io import native\n"
            "from gauss_tpu_torch.ops import _build\n"
            "assert _build._LIB is None and native._LIB is None\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _genome_argv(synpanel, path, lo, hi, wgt, run_dir):
    return ["impute-genome", "--chr", "22", "--start-bp", str(lo),
            "--end-bp", str(hi), "--pop-wgt-file", wgt,
            "--input-file", path,
            "--window-bp", str((hi - lo) // 2 + 1),
            "--wing-size", str(hi - lo),
            "--chunk-bp", str(hi - lo + 1),
            "--run-dir", str(run_dir)] + _ref_argv(synpanel)


def test_cli_impute_genome_and_status(synpanel, gwas_input, region,
                                      tmp_path, capsys):
    path, _ = gwas_input
    lo, hi = region
    wgt = _wgt_file(tmp_path, ["AAA", "BBB"], [0.5, 0.5])
    base_j = _genome_argv(synpanel, path, lo, hi, wgt, tmp_path / "run_j")
    base_t = _genome_argv(synpanel, path, lo, hi, wgt,
                          tmp_path / "run_t") + CPU
    out_j, out_t = tmp_path / "gj.tsv", tmp_path / "gt.tsv"
    j_cli.main(base_j + ["-o", str(out_j)])
    t_cli.main(base_t + ["-o", str(out_t)])
    df = pd.read_csv(out_t, sep="\t")
    _assert_impute_close(df, pd.read_csv(out_j, sep="\t"))

    # a second call resumes: every chunk skipped, the same output
    capsys.readouterr()
    out2 = tmp_path / "gt2.tsv"
    t_cli.main(base_t + ["-o", str(out2)])
    assert "chunks done=0 failed=0 skipped=1" in capsys.readouterr().err
    pd.testing.assert_frame_equal(pd.read_csv(out2, sep="\t"), df)

    # --status is read-only: manifest untouched, chunk ledger printed
    mpath = tmp_path / "run_t" / "manifest.json"
    before = mpath.read_text()
    capsys.readouterr()
    t_cli.main(base_t + ["--status", "-o", str(tmp_path / "ignored.tsv")])
    cap_t = capsys.readouterr()
    j_cli.main(base_j + ["--status", "-o", str(tmp_path / "ignored.tsv")])
    cap_j = capsys.readouterr()
    counts = json.loads(cap_t.out.strip().splitlines()[-1])
    assert counts["done"] >= 1 and counts["failed"] == 0
    assert cap_t.out == cap_j.out and cap_t.err == cap_j.err
    assert mpath.read_text() == before
    assert not os.path.exists(tmp_path / "ignored.tsv")
    with pytest.raises(SystemExit, match="no manifest"):
        t_cli.main(_genome_argv(synpanel, path, lo, hi, wgt,
                                tmp_path / "nowhere") + ["--status"])


@pytest.mark.parametrize("flags", [["--host-linalg"], ["--stream"],
                                   ["--analysis", "qcat"],
                                   ["--analysis", "ld"], ["--restart"]])
def test_cli_impute_genome_options(flags, synpanel, gwas_input, region,
                                   tmp_path):
    path, _ = gwas_input
    lo, hi = region
    wgt = _wgt_file(tmp_path, ["AAA", "BBB"], [0.5, 0.5])
    base_j = _genome_argv(synpanel, path, lo, hi, wgt, tmp_path / "run_j")
    base_t = _genome_argv(synpanel, path, lo, hi, wgt, tmp_path / "run_t")
    log = tmp_path / "trace.jsonl"
    out_j, out_t = tmp_path / "gj.tsv", tmp_path / "gt.tsv"
    j_cli.main(base_j + flags + ["-o", str(out_j)])
    t_cli.main(base_t + flags + CPU + ["--trace-log", str(log),
                                       "-o", str(out_t)])
    got, ref = pd.read_csv(out_t, sep="\t"), pd.read_csv(out_j, sep="\t")
    if flags == ["--analysis", "qcat"]:
        assert list(got.columns) == list(ref.columns) and len(got) > 0
        np.testing.assert_array_equal(got["qcat_m"], ref["qcat_m"])
        np.testing.assert_allclose(got["qcat_t"], ref["qcat_t"], rtol=2e-4,
                                   atol=2e-4)
        np.testing.assert_allclose(got["qcat_chisq"], ref["qcat_chisq"],
                                   rtol=5e-4, atol=5e-4)
    elif flags == ["--analysis", "ld"]:
        _assert_frames_f64(got, ref)
        names = sorted(os.listdir(tmp_path / "run_t" / "results"))
        assert names == sorted(os.listdir(tmp_path / "run_j" / "results"))
        assert any(n.endswith("_cormat.npz") for n in names)
    elif flags == ["--host-linalg"]:
        _assert_frames_f64(got, ref)       # float64 on both sides
    else:
        _assert_impute_close(got, ref)
    phases = [json.loads(x)["phase"] for x in log.read_text().splitlines()]
    assert "chunk" in phases
    assert ("chunk/decode_chunk" in phases) == (flags == ["--stream"])


def test_cli_panel_cache_and_region(synpanel, gwas_input, region, tmp_path):
    path, _ = gwas_input
    lo, hi = region
    cache_j, cache_t = tmp_path / "cache_j", tmp_path / "cache_t"
    j_cli.main(["panel-cache"] + _ref_argv(synpanel) + ["-o", str(cache_j)])
    t_cli.main(["panel-cache"] + _ref_argv(synpanel) + ["-o", str(cache_t)])
    assert sorted(os.listdir(cache_t)) == sorted(os.listdir(cache_j))
    np.testing.assert_array_equal(np.load(cache_t / "G.npy"),
                                  np.load(cache_j / "G.npy"))
    np.testing.assert_array_equal(np.load(cache_t / "af.npy"),
                                  np.load(cache_j / "af.npy"))
    wgt = _wgt_file(tmp_path, ["AAA", "BBB"], [0.5, 0.5])
    argv = ["--chr", "22", "--start-bp", str(lo), "--end-bp", str(hi),
            "--pop-wgt-file", wgt, "--input-file", path,
            "--window-bp", str((hi - lo) // 2 + 1),
            "--wing-size", str(hi - lo)] + _ref_argv(synpanel)

    def run(main, cmd, cache, extra, name):
        out = tmp_path / name
        main([cmd] + argv + ["--panel-cache", str(cache)] + extra
             + ["-o", str(out)])
        return pd.read_csv(out, sep="\t")

    # host float64 windows (no --device-linalg), from either cache
    host_t = run(t_cli.main, "impute-region", cache_j, CPU, "host_t.tsv")
    host_j = run(j_cli.main, "impute-region", cache_j, [], "host_j.tsv")
    assert len(host_t) > 0 and host_t["bp"].is_unique
    _assert_frames_f64(host_t, host_j)
    # the resident kernel (one region, and the host path beside it)
    dev_t = run(t_cli.main, "impute-region", cache_t,
                CPU + ["--device-linalg"], "dev_t.tsv")
    dev_j = run(j_cli.main, "impute-region", cache_j, ["--device-linalg"],
                "dev_j.tsv")
    _assert_impute_close(dev_t, dev_j)
    _assert_impute_close(dev_t, host_t)
    # qcat-region, always on the device; without a cache it decodes bgzf
    q_t = run(t_cli.main, "qcat-region", cache_t, CPU, "q_t.tsv")
    q_j = run(j_cli.main, "qcat-region", cache_j, [], "q_j.tsv")
    assert list(q_t.columns) == list(q_j.columns) and len(q_t) > 0
    np.testing.assert_array_equal(q_t["rsid"], q_j["rsid"])
    np.testing.assert_array_equal(q_t["qcat_m"], q_j["qcat_m"])
    np.testing.assert_allclose(q_t["qcat_t"], q_j["qcat_t"], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(q_t["qcat_chisq"], q_j["qcat_chisq"],
                               rtol=5e-4, atol=5e-4)
    out = tmp_path / "q_bgzf.tsv"
    t_cli.main(["qcat-region"] + argv + CPU + ["-o", str(out)])
    pd.testing.assert_frame_equal(pd.read_csv(out, sep="\t"), q_t)


@pytest.mark.parametrize("cmd,extra", [
    ("afmix", ["--interval", "25"]), ("cpw2", ["--interval", "8"]),
    ("zmix", ["--percentile", "0.5", "--interval", "2"]),
    ("zmix", ["--percentile", "0.5", "--interval", "2", "--level",
              "superpopulation"])])
def test_cli_ancestry_with_and_without_cache(cmd, extra, synpanel,
                                             gwas_input, tmp_path):
    path, _ = gwas_input
    if cmd != "zmix":                  # afmix / cpw2 read study AFs
        path = str(tmp_path / "af.txt")
        gtest.make_af_input(synpanel, path)
    cache = tmp_path / "cache"
    t_cli.main(["panel-cache"] + _ref_argv(synpanel) + ["-o", str(cache)])
    base = [cmd, "--input-file", path] + extra + _ref_argv(synpanel)
    dj, dt = _both(base, tmp_path, "plain")
    _assert_frames_f64(_tsv(dt), _tsv(dj))
    cj, ct = _both(base + ["--panel-cache", str(cache)], tmp_path, "cached")
    _assert_frames_f64(_tsv(ct), _tsv(cj))


def test_cli_genome_jepeg_and_dist_modes(synpanel, gwas_input, region,
                                         tmp_path):
    path, _ = gwas_input
    lo, hi = region
    annot = tmp_path / "annot.txt"
    gtest.make_annotation(synpanel, str(annot))
    span = ["--chr", "22", "--start-bp", str(lo), "--end-bp", str(hi)]

    # homogeneous dist through the ledger (--study-pop, no weights)
    dist = ["impute-genome"] + span + [
        "--study-pop", "EUR", "--input-file", path,
        "--window-bp", str((hi - lo) // 2 + 1), "--wing-size", str(hi - lo),
        "--chunk-bp", str(hi - lo + 1)] + _ref_argv(synpanel)
    out_j, out_t = tmp_path / "dj.tsv", tmp_path / "dt.tsv"
    j_cli.main(dist + ["--run-dir", str(tmp_path / "rdj"), "-o", str(out_j)])
    t_cli.main(dist + CPU + ["--run-dir", str(tmp_path / "rdt"),
                             "-o", str(out_t)])
    df = pd.read_csv(out_t, sep="\t")
    assert "af1ref" in df.columns
    _assert_impute_close(df, pd.read_csv(out_j, sep="\t"))

    # checkpointed jepeg, then jepegmix
    for name, pop in (("jepeg", ["--study-pop", "EUR"]),
                      ("jepegmix", ["--pop-wgt-file", _wgt_file(
                          tmp_path, ["AAA", "BBB"], [0.5, 0.5])])):
        jep = ["impute-genome", "--analysis", "jepeg"] + span + pop + [
            "--input-file", path, "--annotation-file", str(annot),
            "--chunk-bp", str((hi - lo) // 2 + 1)] + _ref_argv(synpanel)
        out_j, out_t = tmp_path / f"{name}_j.tsv", tmp_path / f"{name}_t.tsv"
        j_cli.main(jep + ["--run-dir", str(tmp_path / f"{name}_rj"),
                          "-o", str(out_j)])
        t_cli.main(jep + CPU + ["--run-dir", str(tmp_path / f"{name}_rt"),
                                "-o", str(out_t)])
        dfj = pd.read_csv(out_t, sep="\t")
        assert "jepeg_pval" in dfj.columns
        _assert_frames_f64(dfj, pd.read_csv(out_j, sep="\t"))
        # and the per-call command on the same files
        pj, pt = _both([name] + pop + ["--input-file", path,
                                       "--annotation-file", str(annot)]
                       + _ref_argv(synpanel), tmp_path, name)
        _assert_frames_f64(_tsv(pt), _tsv(pj))

    # both pop modes at once, or neither, fail fast; jepeg needs its file
    for bad in (["--study-pop", "EUR", "--pop-wgt-file", "x.tsv"], [],
                ["--study-pop", "EUR", "--analysis", "jepeg"]):
        with pytest.raises(SystemExit):
            t_cli.main(["impute-genome"] + span + bad + [
                "--input-file", path, "--run-dir", str(tmp_path / "rx")]
                + CPU + _ref_argv(synpanel))


def test_cli_genome_all_failed_exits_nonzero(synpanel, gwas_input, region,
                                             tmp_path, monkeypatch, capsys):
    """A run where EVERY chunk fails exits non-zero with the first error
    on stderr; it does not write an empty TSV and exit 0."""
    from gauss_tpu_torch.models import genome as genome_mod

    def _boom(self, *a, **k):
        raise RuntimeError("synthetic chunk failure")

    monkeypatch.setattr(genome_mod.PreparedRun, "impute_region", _boom)
    monkeypatch.setattr(genome_mod.PreparedRun, "impute_region_async",
                        _boom)
    path, _ = gwas_input
    lo, hi = region
    wgt = _wgt_file(tmp_path, ["AAA", "BBB"], [0.5, 0.5])
    out = tmp_path / "empty.tsv"
    argv = ["impute-genome", "--chr", "22", "--start-bp", str(lo),
            "--end-bp", str(hi), "--pop-wgt-file", wgt,
            "--input-file", path, "--chunk-bp", str(hi - lo + 1),
            "--run-dir", str(tmp_path / "rfail")] + CPU \
        + _ref_argv(synpanel) + ["-o", str(out)]
    with pytest.raises(SystemExit) as ei:
        t_cli.main(argv)
    assert ei.value.code not in (0, None)
    assert "every chunk failed" in str(ei.value.code)
    cap = capsys.readouterr()
    assert "synthetic chunk failure" in cap.err
    assert "[gauss_tpu_torch] first failure" in cap.err
    assert not out.exists()


def test_cli_impute_region_mesh(synpanel, gwas_input, region, tmp_path):
    """impute-region --mesh 2x4 (a repeated CPU) against the unsharded
    --device-linalg output, at gauss_tpu's own bar for the same pair
    (tests/test_cli.py: z rtol 2e-5 / atol 2e-5)."""
    path, _ = gwas_input
    lo, hi = region
    pops = synpanel.desc.pops
    wgt = _wgt_file(tmp_path, pops, [1.0 / len(pops)] * len(pops))
    base = ["impute-region", "--chr", "22", "--start-bp", str(lo),
            "--end-bp", str(hi), "--pop-wgt-file", wgt,
            "--input-file", path, "--window-bp", str((hi - lo) // 3 + 1),
            "--wing-size", str((hi - lo) // 3)] + _ref_argv(synpanel) + CPU
    out_m, out_1 = tmp_path / "mesh.tsv", tmp_path / "one.tsv"
    t_cli.main(base + ["--mesh", "2x4", "-o", str(out_m)])
    t_cli.main(base + ["--device-linalg", "-o", str(out_1)])
    df_m, df_1 = _tsv(tmp_path, "mesh.tsv"), _tsv(tmp_path, "one.tsv")
    assert len(df_m) == len(df_1) > 0
    assert list(df_m["rsid"]) == list(df_1["rsid"])
    for col in ("z", "info"):
        np.testing.assert_allclose(df_m[col], df_1[col], rtol=2e-5,
                                   atol=2e-5)
    # --mesh 1x1: the unsharded output, bit for bit
    t_cli.main(base + ["--mesh", "1x1", "-o", str(out_m)])
    assert out_m.read_text() == out_1.read_text()


def test_cli_impute_genome_mesh(synpanel, gwas_input, region, tmp_path):
    """impute-genome --mesh 2x4 against the unsharded run over the same
    chunks (gauss_tpu's runner bar on a mesh: z rtol 2e-5 / atol 2e-5)."""
    path, _ = gwas_input
    lo, hi = region
    wgt = _wgt_file(tmp_path, ["AAA", "BBB"], [0.5, 0.5])
    window = (hi - lo) // 4 + 1
    base = ["impute-genome", "--chr", "22", "--start-bp", str(lo),
            "--end-bp", str(hi), "--pop-wgt-file", wgt, "--input-file", path,
            "--window-bp", str(window), "--wing-size", str(window),
            "--chunk-bp", str(2 * window)] + _ref_argv(synpanel) + CPU
    t_cli.main(base + ["--mesh", "2x4", "--run-dir", str(tmp_path / "rm"),
                       "-o", str(tmp_path / "mesh.tsv")])
    t_cli.main(base + ["--run-dir", str(tmp_path / "r1"),
                       "-o", str(tmp_path / "one.tsv")])
    df_m, df_1 = _tsv(tmp_path, "mesh.tsv"), _tsv(tmp_path, "one.tsv")
    assert len(df_m) == len(df_1) > 0
    assert list(df_m["rsid"]) == list(df_1["rsid"])
    for col in ("z", "info"):
        np.testing.assert_allclose(df_m[col], df_1[col], rtol=2e-5,
                                   atol=2e-5)
    man = json.loads((tmp_path / "rm" / "manifest.json").read_text())
    assert [c["status"] for c in man["chunks"]] == ["done", "done"]


def test_cli_zmix_mesh(synpanel, gwas_input, tmp_path):
    """zmix --mesh 2x4 over a panel cache: the unsharded run's weights,
    exactly (tests/test_cli.py's case)."""
    path, _ = gwas_input
    cache = tmp_path / "cache"
    t_cli.main(["panel-cache"] + _ref_argv(synpanel) + ["-o", str(cache)])
    base = ["zmix", "--input-file", path, "--percentile", "0.5",
            "--interval", "2"] + _ref_argv(synpanel)
    t_cli.main(base + ["-o", str(tmp_path / "z1.tsv")])
    t_cli.main(base + ["--panel-cache", str(cache), "--mesh", "2x4"] + CPU
               + ["-o", str(tmp_path / "zm.tsv")])
    df_1, df_m = _tsv(tmp_path, "z1.tsv"), _tsv(tmp_path, "zm.tsv")
    assert list(df_m["Population"]) == list(df_1["Population"])
    np.testing.assert_allclose(df_m["Weight"], df_1["Weight"], rtol=0,
                               atol=0)


@pytest.mark.parametrize("cmd,flag", [
    ("zmix", ["--mesh", "2x4"]), ("zmix", ["--mesh", "2x4x1"]),
    ("impute-region", ["--mesh", "2by4"]), ("impute-genome", ["--mesh", "x"])],
    ids=["zmix-no-cache", "zmix-malformed", "region-malformed",
         "genome-malformed"])
def test_cli_refuses_bad_mesh_options(cmd, flag, synpanel, gwas_input,
                                      region, tmp_path):
    """zmix --mesh without --panel-cache, and a malformed --mesh: both
    CLIs exit with gauss_tpu's message and write nothing (the port's
    checks come before any device is asked for)."""
    path, _ = gwas_input
    lo, hi = region
    argv = [cmd, "--input-file", path] + _ref_argv(synpanel)
    if cmd != "zmix":
        argv += ["--chr", "22", "--start-bp", str(lo), "--end-bp", str(hi),
                 "--pop-wgt-file", _wgt_file(tmp_path, ["AAA"], [1.0])]
    if cmd == "impute-genome":
        argv += ["--run-dir", str(tmp_path / "rd")]
    msgs = []
    for main in (t_cli.main, j_cli.main):
        with pytest.raises(SystemExit) as ei:
            main(argv + flag + ["-o", str(tmp_path / "o.tsv")])
        msgs.append(str(ei.value.code))
    assert msgs[0] == msgs[1] and msgs[0].startswith("ERROR: ")
    assert not (tmp_path / "o.tsv").exists()


def test_cli_device_default_is_cuda(synpanel, gwas_input, region, tmp_path):
    """Without --device the engine is asked for ``cuda``: on a machine
    without a card the command fails with torch's error, it does not run
    on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    path, _ = gwas_input
    lo, hi = region
    wgt = _wgt_file(tmp_path, ["AAA", "BBB"], [0.5, 0.5])
    out = tmp_path / "o.tsv"
    with pytest.raises((RuntimeError, AssertionError)):
        t_cli.main(["impute-region", "--device-linalg", "--chr", "22",
                    "--start-bp", str(lo), "--end-bp", str(hi),
                    "--pop-wgt-file", wgt, "--input-file", path,
                    "--wing-size", str(hi - lo)] + _ref_argv(synpanel)
                   + ["-o", str(out)])
    assert not out.exists()


def test_cli_prep_exports(synpanel, gwas_input, region, tmp_path):
    """Every prep_* export has a CLI surface, with gauss_tpu's outputs."""
    path, _ = gwas_input
    lo, hi = region
    for name, extra in [
            ("prep-zmix", ["--interval", "2"]),
            ("prep-zmix2", ["--interval", "7", "--offset", "2"]),
            ("prep-zmix3", ["--interval", "5", "--steps", "2"]),
            ("prep-zmix4", ["--interval", "7", "--offset", "2"]),
            ("prep-zmix5", ["--interval", "2", "--percentile", "0.5"]),
            ("prep-zmix5-sup", ["--interval", "2", "--percentile", "0.5"])]:
        dj, dt = _both([name, "--input-file", path] + _ref_argv(synpanel)
                       + extra, tmp_path, name)
        mat = np.loadtxt(dt / "out.tsv")
        assert mat.ndim == 2 and len(mat) > 0, name
        np.testing.assert_allclose(mat, np.loadtxt(dj / "out.tsv"),
                                   rtol=1e-9, atol=1e-10, err_msg=name)

    span = ["--chr", "22", "--start-bp", str(lo), "--end-bp", str(hi),
            "--wing-size", str(hi - lo), "--input-file", path]
    dj, dt = _both(["prep-qcat"] + span + ["--study-pop", "EUR"]
                   + _ref_argv(synpanel), tmp_path, "pq", npz_out="pq.npz")
    _assert_frames_f64(_tsv(dt), _tsv(dj))
    with np.load(dt / "pq.npz") as a, np.load(dj / "pq.npz") as b:
        assert sorted(a.files) == sorted(b.files) == [
            "cor_mat1", "cor_mat2", "z_vec"]
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-10, atol=1e-12)

    wgt = _wgt_file(tmp_path, synpanel.desc.pops[:2], [0.5, 0.5])
    dj, dt = _both(["prep-recessive-impute"] + span
                   + ["--pop-wgt-file", wgt] + _ref_argv(synpanel),
                   tmp_path, "pr", npz_out="pr.npz")
    _assert_frames_f64(_tsv(dt), _tsv(dj))
    with np.load(dt / "pr.npz") as a, np.load(dj / "pr.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert len(a.files) == 5
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-10, atol=1e-12)

"""Where the port's float64 per-call family computes: on ``device``,
default ``cuda``, never falling back to the CPU.

* every per-call entry point and the functions under it take ``device``
  with the default ``cuda``; without a card (``torch.cuda.is_available``
  patched to False as well) a call without ``device="cpu"`` raises
  torch's own error and returns nothing;
* every per-call CLI subcommand that computes correlations takes
  ``--device`` (default ``cuda``) and fails without a card; the ones that
  compute none have no ``--device``;
* the f32 products run with both TF32 switches off and leave them as the
  caller set them, with the same bits either way;
* on a card (``gpu``): each analysis on ``cuda`` equals the same call on
  the CPU within 1e-12 per column, normwise (exact integer products, the
  same float64 combines; torch's CPU float64 sqrt is not always correctly
  rounded, the card's is), and so does the engine's float64
  ``impute_window``.
"""

import inspect

import numpy as np
import pandas as pd
import pytest
import torch

import gauss_tpu_torch
from gauss_tpu.utils import testing as gtest
from gauss_tpu_torch import cli as t_cli
from gauss_tpu_torch.core import genekernels, ldkernels, stats
from gauss_tpu_torch.ops import gene_stats
from gauss_tpu_torch.io import readers as t_readers
from gauss_tpu_torch.models import ancestry as t_anc
from gauss_tpu_torch.models import genome as t_genome
from gauss_tpu_torch.models.genome import GenomeEngine, PanelStore

POP_WGT = pd.DataFrame({"pop": ["AAA", "BBB", "EEE"],
                        "wgt": [0.4, 0.35, 0.25]})
STUDY_POP = "EUR"
GPU_RTOL = 1e-12

# the per-call entry points, each as (name, call(files, **kw))
WINDOW = ("dist", "distmix", "compute_ld", "qcat", "qcatmix", "prep_qcat",
          "prep_recessive_impute")
PER_CALL = WINDOW + ("jepeg", "jepegmix", "prep_zmix", "prep_zmix5",
                     "prep_zmix5_sup", "zmix")
# the functions under them and the store variants
LOWER = [(ldkernels, "weighted_std"), (ldkernels, "weighted_corr"),
         (ldkernels, "pooled_corr"), (ldkernels, "per_pop_corr"),
         (genekernels, "gene_corr_matrices"), (t_anc, "prep_zmix5_store"),
         (t_anc, "zmix_store")]
# the CLI's per-call subcommands that compute correlations, and those
# that compute none
CLI_DEVICE = ("dist", "distmix", "computeLD", "qcat", "qcatmix", "zmix",
              "jepeg", "jepegmix", "prep-zmix", "prep-zmix5",
              "prep-zmix5-sup", "prep-qcat", "prep-recessive-impute")
CLI_HOST = ("simulateLD", "afmix", "cpw2", "prep-zmix2", "prep-zmix3",
            "prep-zmix4", "fiqt")


@pytest.fixture(scope="module")
def args(synpanel, gwas_input, tmp_path_factory):
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    lo, hi = int(bp.min()), int(bp.max())
    annot = str(tmp_path_factory.mktemp("annot_dev") / "annot.txt")
    gtest.make_annotation(synpanel, annot)
    files = (path, synpanel.files.index_file, synpanel.files.data_file,
             synpanel.files.pop_desc_file)
    return dict(lo=lo, hi=hi, p_lo=lo + (hi - lo) // 3,
                p_hi=lo + 2 * (hi - lo) // 3, wing=(hi - lo) // 3,
                files=files, annot=annot)


def _call(name, a, **kw):
    """``name`` of the port's package as a user calls it (``kw``: its
    device)."""
    fn = getattr(gauss_tpu_torch, name)
    f = a["files"]
    if name == "compute_ld":
        return fn(22, a["lo"], a["hi"], POP_WGT, *f, **kw)
    if name in WINDOW:
        pops = STUDY_POP if name in ("dist", "qcat", "prep_qcat") \
            else POP_WGT
        return fn(22, a["p_lo"], a["p_hi"], a["wing"], pops, *f, **kw)
    if name == "jepeg":
        return fn(STUDY_POP, f[0], a["annot"], *f[1:], **kw)
    if name == "jepegmix":
        return fn(POP_WGT, f[0], a["annot"], *f[1:], **kw)
    extra = dict(interval=2) if name == "prep_zmix" else \
        dict(percentile=0.5, interval=2)
    return fn(*f, **extra, **kw)


@pytest.fixture
def no_card(monkeypatch):
    """A machine without a card, as torch reports it."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", PER_CALL)
def test_per_call_default_is_cuda_and_never_falls_back(name, args, no_card):
    fn = getattr(gauss_tpu_torch, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises((RuntimeError, AssertionError)):
        _call(name, args)


@pytest.mark.parametrize("mod, name", LOWER,
                         ids=[n for _, n in LOWER])
def test_lower_functions_default_to_cuda(mod, name, synpanel, gwas_input,
                                         no_card):
    fn = getattr(mod, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    G = synpanel.genotypes[:16]
    sizes = tuple(int(x) for x in synpanel.desc.sizes)
    wgts = tuple(1.0 / len(sizes) for _ in sizes)
    calls = {
        "weighted_std": lambda: fn(G, sizes, wgts),
        "weighted_corr": lambda: fn(G, G, sizes, wgts),
        "pooled_corr": lambda: fn(G, G),
        "per_pop_corr": lambda: fn(G, sizes),
        "gene_corr_matrices": lambda: fn([G[:5], G[5:9]], sizes, wgts),
        "prep_zmix5_store": lambda: fn(
            PanelStore.from_bgzf(synpanel.files, chrom=22),
            t_readers.read_input_z(gwas_input[0], all_snps=True), 0.5, 2),
        "zmix_store": lambda: fn(
            PanelStore.from_bgzf(synpanel.files, chrom=22),
            t_readers.read_input_z(gwas_input[0], all_snps=True), 0.5, 2),
    }
    with pytest.raises((RuntimeError, AssertionError)):
        calls[name]()


def _cli_argv(cmd, a, tmp_path):
    f = a["files"]
    ref = ["--reference-index-file", f[1], "--reference-data-file", f[2],
           "--reference-pop-desc-file", f[3]]
    wgt = tmp_path / "wgt.tsv"
    POP_WGT.to_csv(wgt, sep="\t", index=False)
    study = ["--study-pop", STUDY_POP]
    mix = ["--pop-wgt-file", str(wgt)]
    win = ["--chr", "22", "--start-bp", str(a["p_lo"]), "--end-bp",
           str(a["p_hi"]), "--input-file", f[0]]
    out = ["-o", str(tmp_path / "out.tsv")]
    if cmd in ("dist", "qcat"):
        return [cmd] + win + study + ["--wing-size", str(a["wing"])] + ref \
            + out
    if cmd in ("distmix", "qcatmix"):
        return [cmd] + win + mix + ["--wing-size", str(a["wing"])] + ref \
            + out
    if cmd == "computeLD":
        return [cmd] + win + mix + ref + out
    if cmd in ("prep-qcat", "prep-recessive-impute"):
        return [cmd] + win + (study if cmd == "prep-qcat" else mix) + [
            "--wing-size", str(a["wing"]), "--npz-out",
            str(tmp_path / "o.npz")] + ref + out
    if cmd in ("jepeg", "jepegmix"):
        return [cmd, "--input-file", f[0], "--annotation-file",
                a["annot"]] + (study if cmd == "jepeg" else mix) + ref + out
    extra = ["--interval", "2"] + (["--percentile", "0.5"]
                                   if cmd != "prep-zmix" else [])
    return [cmd, "--input-file", f[0]] + extra + ref + out


@pytest.mark.parametrize("cmd", CLI_DEVICE)
def test_cli_per_call_default_is_cuda(cmd, args, tmp_path, no_card):
    """Without --device the command asks for ``cuda``: it fails with
    torch's error and writes nothing."""
    argv = _cli_argv(cmd, args, tmp_path)
    with pytest.raises((RuntimeError, AssertionError)):
        t_cli.main(argv)
    assert not (tmp_path / "out.tsv").exists()
    assert not (tmp_path / "o.npz").exists()


def test_cli_device_only_where_correlations_run(capsys):
    """``--device`` (default cuda) on the subcommands that compute
    correlations; the host-only ones reject it."""
    for cmd in CLI_DEVICE:
        with pytest.raises(SystemExit) as ei:
            t_cli.main([cmd, "--help"])
        assert ei.value.code == 0
        assert "--device" in capsys.readouterr().out, cmd
    for cmd in CLI_HOST:
        with pytest.raises(SystemExit):
            t_cli.main([cmd, "--help"])
        assert "--device" not in capsys.readouterr().out, cmd


SPIES = [(stats, "pop_cross_products"), (stats, "pooled_corr_matrix"),
         (stats, "per_pop_corr_matrices"), (gene_stats, "gene_partials")]


@pytest.mark.parametrize("name", ["distmix", "dist", "compute_ld",
                                  "jepegmix", "prep_zmix5", "impute_window"])
def test_per_call_products_in_full_f32(name, args, synpanel, gwas_input,
                                       monkeypatch):
    """The caller's TF32 switch on: every f32 product of the call runs
    with both switches off, the result has the same bits as with the
    switches off, and the switches are the caller's again afterwards."""
    flags = lambda: (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    inside = []
    for mod, fn in SPIES:
        real = getattr(mod, fn)

        def spy(*a, _real=real, **k):
            inside.append(flags())
            return _real(*a, **k)
        monkeypatch.setattr(mod, fn, spy)

    def run():
        if name != "impute_window":
            return _call(name, args, device="cpu")
        a = args
        eng = GenomeEngine(PanelStore.from_bgzf(synpanel.files, chrom=22),
                           device="cpu")
        inp = t_readers.read_input_z(a["files"][0], chrom=22,
                                     start_bp=a["p_lo"], end_bp=a["p_hi"],
                                     wing_size=a["wing"])
        pop = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
        return eng.prepare_mix(inp, pop, af1_cutoff=0.01).impute_window(
            a["p_lo"], a["p_hi"], a["wing"]).table

    saved = flags()
    try:
        outs = []
        for before in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = before
            torch.backends.cudnn.allow_tf32 = before
            outs.append(run())
            assert flags() == (before, before)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
    assert inside and all(f == (False, False) for f in inside)
    if isinstance(outs[0], pd.DataFrame):
        pd.testing.assert_frame_equal(outs[0], outs[1], check_exact=True)
    elif isinstance(outs[0], dict):
        np.testing.assert_array_equal(outs[0]["cormat"], outs[1]["cormat"])
    else:
        np.testing.assert_array_equal(outs[0], outs[1])


def test_engine_window_path_on_its_device(args, synpanel, monkeypatch):
    """impute_window without device_linalg computes its blocks on the
    engine's device: the blocks function sees tensors there, and the
    solve gets CPU float64 blocks."""
    seen = []
    real = t_genome._build_corr_blocks_fn

    def spy(*a, **k):
        fn = real(*a, **k)

        def wrapped(Gm, Gu):
            seen.append((Gm.device, Gu.device))
            out = fn(Gm, Gu)
            seen.append(tuple(B.device for B in out))
            return out
        return wrapped
    monkeypatch.setattr(t_genome, "_build_corr_blocks_fn", spy)
    eng = GenomeEngine(PanelStore.from_bgzf(synpanel.files, chrom=22),
                       device="cpu")
    a = args
    inp = t_readers.read_input_z(a["files"][0], chrom=22,
                                 start_bp=a["p_lo"], end_bp=a["p_hi"],
                                 wing_size=a["wing"])
    pop = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    res = eng.prepare_mix(inp, pop, af1_cutoff=0.01).impute_window(
        a["p_lo"], a["p_hi"], a["wing"])
    assert len(res.table) and seen
    assert all(d == torch.device("cpu") for pair in seen for d in pair)


def _same_within(got, ref, rtol):
    """Per float column (or array), normwise: max |got - ref| <= rtol *
    max |ref| where ref is finite, non-finite entries equal; other
    columns equal.  (The card's float64 sqrt is correctly rounded and
    torch's CPU one is not always, so the blocks differ by an ulp and the
    host solve carries it into every z: an elementwise ratio at a z near
    0 would not measure the agreement.)"""
    if isinstance(ref, pd.DataFrame):
        assert list(got.columns) == list(ref.columns) and len(ref)
        for col in ref.columns:
            a, b = got[col].to_numpy(), ref[col].to_numpy()
            if b.dtype.kind == "f":
                _same_within(a, b, rtol)
            else:
                assert list(a) == list(b), col
    elif isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _same_within(got[k], ref[k], rtol)
    else:
        a, b = np.asarray(got, dtype=float), np.asarray(ref, dtype=float)
        fin = np.isfinite(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[~fin], b[~fin])
        if fin.any():
            np.testing.assert_allclose(a[fin], b[fin], rtol=0,
                                       atol=rtol * np.abs(b[fin]).max())


@pytest.mark.gpu
def test_per_call_family_on_the_card_equals_the_cpu(args, synpanel):
    """Every per-call analysis and the engine's float64 impute_window on
    ``cuda`` against the same call on the CPU: 1e-12 normwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name in PER_CALL:
        _same_within(_call(name, args, device="cuda"),
                     _call(name, args, device="cpu"), GPU_RTOL)
    store = PanelStore.from_bgzf(synpanel.files, chrom=22)
    a = args
    inp = t_readers.read_input_z(a["files"][0], chrom=22,
                                 start_bp=a["p_lo"], end_bp=a["p_hi"],
                                 wing_size=a["wing"])
    pop = dict(zip(POP_WGT["pop"], POP_WGT["wgt"]))
    got, ref = (GenomeEngine(store, device=d).prepare_mix(
        inp, pop, af1_cutoff=0.01).impute_window(
            a["p_lo"], a["p_hi"], a["wing"]).table for d in ("cuda", "cpu"))
    _same_within(got, ref, GPU_RTOL)

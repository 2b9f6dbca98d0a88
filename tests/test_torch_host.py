"""gauss_tpu_torch host layer: the modules carried over from gauss_tpu
give identical outputs, the panel state converts across, and the
package never imports JAX."""

import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from gauss_tpu.core import variants as j_variants
from gauss_tpu.io import readers as j_readers
from gauss_tpu.models.genome import PanelStore as JStore
from gauss_tpu.utils import benchdata as j_benchdata
from gauss_tpu.utils import testing as j_testing
from gauss_tpu_torch import convert
from gauss_tpu_torch.config import PanelFiles
from gauss_tpu_torch.core import variants as t_variants
from gauss_tpu_torch.io import readers as t_readers
from gauss_tpu_torch.models.genome import PanelStore as TStore
from gauss_tpu_torch.utils import benchdata as t_benchdata
from gauss_tpu_torch.utils import testing as t_testing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files(p):
    return (p.files.index_file, p.files.data_file, p.files.pop_desc_file)


def _assert_store_equal(a, b):
    np.testing.assert_array_equal(a.G, b.G)
    np.testing.assert_array_equal(a.af, b.af)
    pd.testing.assert_frame_equal(a.index.reset_index(drop=True),
                                  b.index.reset_index(drop=True))
    assert list(a.desc.pops) == list(b.desc.pops)
    np.testing.assert_array_equal(a.desc.sizes, b.desc.sizes)
    assert list(a.desc.sup_pops) == list(b.desc.sup_pops)


def test_read_input_z_identical(synpanel, gwas_input):
    path, _ = gwas_input
    bp = synpanel.index_df["bp"]
    kw = dict(chrom=22, start_bp=int(bp.min()), end_bp=int(bp.max()),
              wing_size=50_000)
    a = j_readers.read_input_z(path, **kw)
    b = t_readers.read_input_z(path, **kw)
    assert len(a) > 0
    pd.testing.assert_frame_equal(a, b)
    pd.testing.assert_frame_equal(j_readers.read_input_z(path, all_snps=True),
                                  t_readers.read_input_z(path, all_snps=True))


def test_join_reference_index_identical(synpanel, gwas_input):
    path, _ = gwas_input
    inp = j_readers.read_input_z(path, all_snps=True)
    index = JStore.from_bgzf(synpanel.files).index
    for add_unmeasured in (True, False):
        a = j_variants.join_reference_index(inp, index,
                                            add_unmeasured=add_unmeasured)
        b = t_variants.join_reference_index(inp, index,
                                            add_unmeasured=add_unmeasured)
        assert len(a) > 0
        pd.testing.assert_frame_equal(a, b)


def test_make_scaled_panel_identical():
    a = j_benchdata.make_scaled_panel(200, bp_span=200 * 2000 // 3)
    b = t_benchdata.make_scaled_panel(200, bp_span=200 * 2000 // 3)
    assert isinstance(b, TStore)
    assert a.G.shape == (200, 33153)
    _assert_store_equal(a, b)
    pd.testing.assert_frame_equal(j_benchdata.make_bench_input(a, 0.4),
                                  t_benchdata.make_bench_input(b, 0.4))


def test_synthetic_panel_writer_identical(tmp_path):
    a = j_testing.make_synthetic_panel(str(tmp_path / "a"), n_snps=60)
    b = t_testing.make_synthetic_panel(str(tmp_path / "b"), n_snps=60)
    np.testing.assert_array_equal(a.genotypes, b.genotypes)
    for fa, fb in zip(_files(a), _files(b)):
        with open(fa, "rb") as x, open(fb, "rb") as y:
            assert x.read() == y.read()


def test_panel_store_from_bgzf_matches(synpanel):
    a = JStore.from_bgzf(synpanel.files)
    b = TStore.from_bgzf(PanelFiles(*_files(synpanel)))
    _assert_store_equal(a, b)


def test_panel_from_numpy_round_trip(synpanel, tmp_path):
    a = JStore.from_bgzf(synpanel.files)
    b = convert.panel_from_numpy(a.index, a.G, a.af, a.desc.pops,
                                 a.desc.sizes, a.desc.sup_pops)
    assert isinstance(b, TStore)
    _assert_store_equal(a, b)
    b.save(str(tmp_path / "store"))
    _assert_store_equal(a, TStore.load(str(tmp_path / "store")))
    _assert_store_equal(a, JStore.load(str(tmp_path / "store")))


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import gauss_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'gauss_tpu'))\n"
        "assert not bad, bad\n"
        "print(len([k for k in sys.modules if k.startswith(p.__name__)]))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


def test_native_decoder_builds_and_decodes_like_gauss_tpu(synpanel,
                                                          tmp_path,
                                                          monkeypatch):
    """The port compiles its own copy of the decoder (g++, zlib) and
    decodes the conftest panel exactly as gauss_tpu's pure-Python reader
    does; a source that does not compile raises with the compiler's
    output when the decoder is required, and warns and falls back to
    the Python reader when it is not."""
    from gauss_tpu.io.panel import PanelReader as JReader
    from gauss_tpu_torch.io import native
    from gauss_tpu_torch.io.panel import PanelReader as TReader
    from gauss_tpu_torch.io.panel import read_panel_index as t_index

    so = native.build()
    assert so.startswith(native.BUILD_DIR) and os.path.exists(so)
    assert native.available()
    desc = t_readers.read_pop_desc(synpanel.files.pop_desc_file)
    fpos = t_index(synpanel.files.index_file)["fpos"].to_numpy()[::-3]
    flags = np.zeros(desc.num_pops, dtype=np.int8)
    flags[[0, 2, 3]] = 1
    for kw in (dict(), dict(pop_flags=flags),
               dict(want_genotypes=False)):
        ref = JReader(synpanel.files.data_file, desc,
                      use_native=False).decode_rows(fpos, **kw)
        got = TReader(synpanel.files.data_file, desc,
                      use_native=True).decode_rows(fpos, **kw)
        for a, b in ((got.G, ref.G), (got.af, ref.af),
                     (got.pop_sizes, ref.pop_sizes)):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)

    bad = tmp_path / "panel_decoder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    with pytest.warns(RuntimeWarning, match="g\\+\\+ failed"):
        assert not native.available()
    assert not TReader(synpanel.files.data_file, desc).use_native
    with pytest.raises(RuntimeError, match="not C\\+\\+|error"):
        TReader(synpanel.files.data_file, desc,
                use_native=True).decode_rows(fpos[:3])

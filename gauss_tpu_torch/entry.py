"""Entry points for a compile-and-run check: the resident distmix
imputation kernel on a toy window batch, and a mesh dry run.

* entry(device) -> (fn, example_args): the port's resident impute kernel
  (``ops/window_kernel.build_resident_region_kernel``) and its arguments
  on ``device``; ``fn(*example_args)`` gives the stacked [2, W, Up]
  (z, info).  On a CUDA device the preparation gathers with K2 and the
  call launches K1; on the CPU both take their plain versions.
* dryrun_multichip(n_devices, device) -- the engine's mesh paths over an
  n-device (window x subject) mesh on a synthetic bgzf panel, each
  against the engine on one device.
"""

from __future__ import annotations

import numpy as np
import torch


def _toy_window(n_windows=2, M=24, U=16, pop_sizes=(12, 20, 8), seed=0):
    rng = np.random.default_rng(seed)
    S = int(sum(pop_sizes))
    Gm = rng.integers(0, 3, size=(n_windows, M, S), dtype=np.int8)
    Gu = rng.integers(0, 3, size=(n_windows, U, S), dtype=np.int8)
    Z1 = rng.standard_normal((n_windows, M))
    m_mask = np.ones((n_windows, M), dtype=np.float32)
    u_mask = np.ones((n_windows, U), dtype=np.float32)
    m_mask[:, -3:] = 0.0  # exercise padding/masking
    u_mask[:, -2:] = 0.0
    Gm[:, -3:] = 0
    Gu[:, -2:] = 0
    Z1[:, -3:] = 0.0
    return Gm, Gu, Z1, m_mask, u_mask


def entry(device):
    """The resident impute kernel and its arguments on ``device`` for the
    toy window batch: every window's measured / unmeasured rows are one
    aligned band of a panel built from the toy blocks (population
    segments zero-padded to K1's K_CHUNK columns)."""
    from .ops.gram import K_CHUNK, ROW_TILE
    from .ops.window_kernel import (WindowKernelSpec,
                                    build_resident_region_kernel,
                                    pad_pop_segments,
                                    prepare_resident_panel)

    device = torch.device(device)
    pop_sizes = (12, 20, 8)
    Gm, Gu, Z1, m_mask, u_mask = _toy_window(pop_sizes=pop_sizes)
    W, M, U = Gm.shape[0], Gm.shape[1], Gu.shape[1]
    Mp = -(-M // ROW_TILE) * ROW_TILE
    Up = -(-U // ROW_TILE) * ROW_TILE
    panel, padded = pad_pop_segments(
        np.concatenate([Gm.reshape(W * M, -1), Gu.reshape(W * U, -1)]),
        pop_sizes, multiple=K_CHUNK)
    spec = WindowKernelSpec(pop_sizes=pop_sizes, pop_sizes_padded=padded,
                            wgts=(0.5, 0.3, 0.2))

    def band_rows(first, n, band):
        rows = np.full(W * band, -1, dtype=np.int32)
        for w in range(W):
            rows[w * band:w * band + n] = first + w * n + np.arange(n)
        return torch.from_numpy(rows).to(device)

    G_dev = torch.from_numpy(np.ascontiguousarray(panel)).to(device)
    Xm, Spm, Mum, _ = prepare_resident_panel(G_dev, band_rows(0, M, Mp),
                                             None, spec)
    Xu, Spu, Muu, Vu = prepare_resident_panel(
        G_dev, band_rows(W * M, U, Up), None, spec)

    def padded_to(a, width):
        out = np.zeros((W, width), dtype=np.float32)
        out[:, :a.shape[1]] = a
        return torch.from_numpy(out).to(device)

    m_t0 = torch.arange(W, dtype=torch.int32, device=device) * Mp
    u_t0 = torch.arange(W, dtype=torch.int32, device=device) * Up
    fn = build_resident_region_kernel(spec, Mp, Up)
    args = (Xm, Xu, Spm, Spu, Mum, Muu, Vu, m_t0, u_t0,
            padded_to(Z1, Mp), padded_to(m_mask, Mp), padded_to(u_mask, Up))
    return fn, args


def _factor(n_devices: int):
    """(n_window, n_subject) of an n-device mesh: (1, n) or (2, n / 2),
    the subject axis 2 or 4 wide where it divides, as gauss_tpu's dry run
    factors it."""
    n_sub = 1
    for cand in (2, 4):
        if n_devices % cand == 0:
            n_sub = cand
    return n_devices // n_sub, n_sub


def dryrun_multichip(n_devices: int, device="cuda", n_snps: int = 4000):
    """The engine's multi-device paths on an n-device (window x subject)
    mesh of ``device``'s type (the first n cards; the CPU repeated n
    times), on a synthetic bgzf panel of ``n_snps`` SNPs over 4 Mb: panel
    decode, join, subject-shard layout, impute_region, a checkpointed
    GenomeRunner over the mesh engine, qcat_region, ld_region, jepegmix
    genes and zmix, each against the same call on one device.  Returns
    the measured differences; raises when one is out of bounds."""
    import os
    import tempfile

    from .io import readers
    from .models import ancestry
    from .models.genome import GenomeEngine, PanelStore
    from .models.runner import GenomeRunner
    from .parallel.mesh import make_mesh
    from .utils.testing import (make_af_input, make_annotation,
                                make_gwas_input, make_synthetic_panel)

    device = torch.device(device)
    n_win, n_sub = _factor(n_devices)
    mesh = make_mesh(n_win, n_sub, devices=None if device.type == "cuda"
                     else [device] * n_devices)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        panel = make_synthetic_panel(d, n_snps=n_snps,
                                     bp_step=4_000_000 // n_snps)
        zpath = os.path.join(d, "zin.txt")
        make_gwas_input(panel, zpath, measured_frac=0.55, seed=3)
        lo, hi = 1_000_000, 4_999_000
        inp = readers.read_input_z(zpath, chrom=22, start_bp=lo, end_bp=hi,
                                   wing_size=0)
        store = PanelStore.from_bgzf(panel.files, chrom=22)
        pop_wgt = {p: 1.0 / len(panel.desc.pops) for p in panel.desc.pops}
        kw = dict(window_bp=250_000, wing_size=125_000)
        eng = GenomeEngine(store, mesh=mesh)
        eng1 = GenomeEngine(store, mesh.devices[0, 0], device_linalg=True)
        run_m = eng.prepare_mix(inp, pop_wgt)
        run_1 = eng1.prepare_mix(inp, pop_wgt)
        df, df1 = (r.impute_region(lo, hi, **kw) for r in (run_m, run_1))
        if not (len(df) == len(df1) > 0 and np.isfinite(df["z"]).all()):
            raise AssertionError(f"mesh region: {len(df)} rows, one "
                                 f"device {len(df1)}")
        out["dz"] = float(np.abs(df["z"] - df1["z"]).max())
        out["dinfo"] = float(np.abs(df["info"] - df1["info"]).max())

        # one checkpointed GenomeRunner over the mesh engine
        runner = GenomeRunner(os.path.join(d, "mesh_run"), eng, inp,
                              pop_wgt=pop_wgt, chunk_bp=2_000_000, **kw)
        runner.plan(chrom=22, start_bp=lo, end_bp=hi)
        runner.run(resume=True)
        st = runner.status()
        if st.get("done", 0) < 2 or st.get("failed"):
            raise AssertionError(f"mesh runner: {st}")
        df_r = runner.collect()
        out["dz_runner"] = float(np.abs(df_r["z"].to_numpy()
                                        - df["z"].to_numpy()).max())

        qlo, qhi = lo, lo + 999_000
        q_m, q_1 = (r.qcat_region(qlo, qhi, **kw) for r in (run_m, run_1))
        if not (len(q_m) == len(q_1) > 0
                and (q_m["qcat_m"] == q_1["qcat_m"]).all()):
            raise AssertionError("mesh qcat rows or qcat_m differ")
        out["dqcat_chisq"] = float(np.abs(q_m["qcat_chisq"]
                                          - q_1["qcat_chisq"]).max())
        ld_m, ld_1 = (r.ld_region(qlo, qhi, window_bp=250_000, fetch="f32")
                      for r in (run_m, run_1))
        if not len(ld_m) == len(ld_1) > 0:
            raise AssertionError("mesh ld_region windows differ")
        out["dld"] = max(float(np.nanmax(np.abs(a["cormat"] - b["cormat"])))
                         for a, b in zip(ld_m, ld_1))

        af_path = os.path.join(d, "af.txt")
        make_af_input(panel, af_path, pop_mix=pop_wgt)
        af_m = eng.afmix(readers.read_input_af(af_path), interval=8)
        if not (len(af_m) > 0 and np.isfinite(af_m["wgt"]).all()):
            raise AssertionError("afmix on the mesh engine")

        apath = os.path.join(d, "annot.txt")
        make_annotation(panel, apath)
        annot = readers.read_annotation(apath)
        inp_all = readers.read_input_z(zpath, all_snps=True)
        gj_m, gj_1 = (e.prepare_genes(inp_all, annot, pop_wgt=pop_wgt)
                      .jepeg_region() for e in (eng, eng1))
        if not len(gj_m) == len(gj_1) > 0:
            raise AssertionError("mesh jepeg genes differ")
        out["dchisq_genes"] = float(np.abs(gj_m["chisq"]
                                           - gj_1["chisq"]).max())

        z_m = ancestry.zmix_store(store, inp_all, percentile=0.5,
                                  interval=8, mesh=mesh)
        z_1 = ancestry.zmix_store(store, inp_all, percentile=0.5,
                                  interval=8)
        out["dw_zmix"] = float(np.abs(z_m["Weight"] - z_1["Weight"]).max())
    # the f32 partial sums of T1 over the shards, added in another order
    # than one device's fold, move z by f32 noise amplified through
    # cond(B11); the gene and zmix statistics are exact integers
    bounds = {"dz": 5e-5, "dinfo": 1e-5, "dz_runner": 1e-5,
              "dqcat_chisq": 1e-4, "dld": 1e-5, "dchisq_genes": 1e-9,
              "dw_zmix": 0.0}
    bad = {k: v for k, v in out.items() if not v <= bounds[k]}
    if bad:
        raise AssertionError(f"mesh ({n_win} x {n_sub}) against one "
                             f"device: {bad} above {bounds}")
    print(f"dryrun_multichip OK: mesh ({n_win} windows x {n_sub} subject "
          f"shards) on {device.type}, {len(store.index)}-SNP panel, "
          f"{int((df['type'] == 0).sum())} imputed rows; against one "
          f"device: {out}")
    return out

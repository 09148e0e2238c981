"""The studies' ``shard=`` (``--shard``): the port's sharded study runs
against its own unsharded runs, mirroring ``tests/test_studies.py``'s
three sharded tests on their coarse mesh (h = 0.2): Phase-B on the
reference geometry through the CLI (``--shard 4 --tp 2 --device cpu``;
the CLI's three mu factors, the JAX test's 0.1 and 1 among them, padded
from 3 to 4 columns over dp = 2), the no-uptake study (``square_small``
and the rectangle, Pe 0.1 and 10: sharded Stokes, then the Pe batch) and
the adv-diff step-mu validation (Pe 1, mu factors 0.1 and 10: both Stokes
solves, the sulcus batch and the per-sample Robin surrogates).  Rows
within 1e-8 relative (1e-7 for adv-diff), as JAX holds its own.  Four gloo
ranks on the CPU (2 sweep rows x 2 cells ranks).

On the card (marker ``cuda``, ``--noconftest``): the sharded MG-CG at 2
gloo ranks sharing the card against the unsharded f64 solve, every block
apply a launch of kernel C.
"""

import csv
import os

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.parallel.sharding import RankGroup

COARSE = 0.2


@pytest.fixture(scope="module")
def group():
    g = RankGroup(4, tp=2, device="cpu")
    yield g
    g.close()


def _rel(a, b, floor=1e-300):
    a, b = np.asarray(a, float), np.asarray(b, float)
    ok = np.isfinite(a) & np.isfinite(b)
    assert ok.any()
    return float((np.abs(a[ok] - b[ok])
                  / np.maximum(np.abs(b[ok]), floor)).max())


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _col(rows, key):
    return np.array([float(r[key]) if r[key] not in ("", None) else np.nan
                     for r in rows])


def test_phase_b_cli_sharded_matches_unsharded(tmp_path):
    """``python -m ...studies.phase_b --shard 4 --tp 2 --device cpu``
    writes the rows of the unsharded run within 1e-8."""
    from fenics_eff_uptake_tpu_torch.studies import phase_b
    ref, _ = phase_b.run_no_adv_mu_sweep(
        "cpu", str(tmp_path / "ref"), COARSE, geometries=["reference"],
        verbose=False)
    phase_b.main(["--mesh-size", str(COARSE), "--geometries", "reference",
                  "--output-base", str(tmp_path / "sh"), "--device", "cpu",
                  "--shard", "4", "--tp", "2"])
    sh = _csv(os.path.join(tmp_path, "sh", "mu Sweep Analysis",
                           phase_b.CSV_NAME))
    assert len(sh) == len(ref) == 3
    for col in ("CR", "flux_ratio", "avg_conc_sulc", "avg_conc_rect",
                "flux_sulc_y0", "flux_rect_bottom"):
        assert _rel(_col(sh, col), [r[col] for r in ref]) < 1e-8, col


@pytest.mark.slow
def test_no_uptake_sharded_matches_unsharded(tmp_path, group, monkeypatch):
    monkeypatch.setenv("FEU_CACHE_DIR", str(tmp_path / "cache"))
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import \
        run_geometry_study
    kw = dict(peclet_numbers=[0.1, 10.0], mesh_size_dim=COARSE,
              geometries=["square_small"], device="cpu", verbose=False)
    ref, _ = run_geometry_study(base_dir=str(tmp_path / "ref"), **kw)
    sh, stats = run_geometry_study(base_dir=str(tmp_path / "sh"),
                                   shard=group, **kw)
    assert len(sh) == len(ref) == 4
    assert all(s["stokes_method"].startswith("minres+mg+sharded")
               for s in stats)
    for col in ("Avg Concentration", "Total Mass", "Mouth E_L1",
                "Concentration_Ratio"):
        a = np.array([np.nan if r[col] is None else r[col] for r in sh])
        b = np.array([np.nan if r[col] is None else r[col] for r in ref])
        assert _rel(a, b, 1e-6) < 1e-8, col


@pytest.mark.slow
def test_advdiff_sharded_matches_unsharded(tmp_path, group, monkeypatch):
    monkeypatch.setenv("FEU_CACHE_DIR", str(tmp_path / "cache"))
    from fenics_eff_uptake_tpu_torch.studies.adv_diff import \
        run_advdiff_step_validation
    kw = dict(mesh_size_dim=COARSE, pe_values=[1.0], mu_factors=[0.1, 10.0],
              device="cpu", verbose=False)
    ref, _ = run_advdiff_step_validation(str(tmp_path / "ref"), **kw)
    sh, _ = run_advdiff_step_validation(str(tmp_path / "sh"), shard=group,
                                        **kw)
    assert len(sh) == len(ref) == 4
    for col in ("total_flux", "uptake_flux", "avg_conc", "mu_eff_open"):
        a = np.array([np.nan if r[col] is None else r[col] for r in sh])
        b = np.array([np.nan if r[col] is None else r[col] for r in ref])
        assert _rel(a, b, 1e-6) < 1e-7, col


@pytest.mark.cuda
def test_sharded_cg_on_the_card_matches_unsharded():
    """Two gloo ranks on the card (tp = 2: the element chunks split, one
    all-reduce of CUDA tensors per apply) run the MG-CG of a 4-column
    sweep at h = 0.05; X within 1e-9 of the unsharded f64 solve, and every
    block apply in the ranks a launch of kernel C."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
    from fenics_eff_uptake_tpu_torch.parallel.sharded_solve import \
        solve_sweep_sharded
    from fenics_eff_uptake_tpu_torch.parallel.sweep import (
        build_transport_system, solve_sweep)
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import \
        build_multilevel_for
    mesh = generate_mesh(width=5.0, height=1.0, sulcus_depth=0.5,
                         sulcus_width=0.5, mesh_size=0.05,
                         refinement_factor=1, domain_type="sulcus")
    sys = build_transport_system(mesh, "cuda")
    D, mus = np.ones(4), np.array([0.1, 1.0, 10.0, 100.0])
    ml = build_multilevel_for(sys, mesh, D, mus)
    with RankGroup(2, tp=2, device="cuda", backend="gloo") as g:
        X, info = solve_sweep_sharded(g, sys, D, mus, multilevel=ml,
                                      rtol=1e-11, chunk_iters=20)
        launches = g.launches
    assert info["converged"].all() and info["all_reduces_per_iter"] == 3
    assert launches["element_apply"] > 0
    Xu, _ = solve_sweep(sys, D, mus, rtol=1e-12, multilevel=ml,
                        precision="f64")
    assert float((X - Xu).abs().max()) < 1e-9

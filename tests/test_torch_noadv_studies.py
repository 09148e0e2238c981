"""The port's no-advection studies against the JAX package's.

The three Phase-A studies that ride on ``no_adv_batch`` (aspect ratio,
geometry, mu_eff) and Phase-B's sulcus-against-rectangle sweep, on cut-down
grids at h = 0.15 (no hierarchy on either side: Jacobi-preconditioned CG,
the port in mixed precision, JAX's CPU default in f64, both to rtol 1e-12):
every numeric column row for row at 1e-7 relative (Phase-B's
``flux_error_pct``, a difference of fluxes in percent: 1e-5 absolute), text
columns equal, headers equal to the committed artifacts'.
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu.studies import phase_a as jphase_a
from fenics_eff_uptake_tpu.studies import phase_b as jphase_b
from fenics_eff_uptake_tpu_torch.analysis.mu_eff import sample_mu_along_bottom
from fenics_eff_uptake_tpu_torch.params import StepUptakeOpen
from fenics_eff_uptake_tpu_torch.studies import phase_a as tphase_a
from fenics_eff_uptake_tpu_torch.studies import phase_b as tphase_b

torch.set_num_threads(2)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
H = 0.15


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _hold(written, rows, df, golden_path, abs_cols=()):
    """The port's CSV (as written and as returned) against the JAX
    DataFrame, and its header against the artifact's."""
    golden = _read(golden_path)
    assert list(written[0]) == list(golden[0]) == list(df.columns)
    assert len(written) == len(rows) == len(df) > 0
    for i, (w, r) in enumerate(zip(written, rows)):
        ref = df.iloc[i]
        for col in golden[0]:
            if isinstance(ref[col], str):
                assert w[col] == str(r[col]) == ref[col], (i, col)
            elif w[col] == "":
                assert ref[col] is None or np.isnan(ref[col]), (i, col)
            elif col in abs_cols:
                assert abs(float(w[col]) - ref[col]) <= 1e-5, (i, col)
            else:
                assert float(w[col]) == pytest.approx(
                    float(ref[col]), rel=1e-7, abs=1e-12), (i, col)


def _check_stats(stats):
    for s in stats:
        assert not s["multilevel"]
        assert max(s["rel_resnorm"]) <= 1e-11


def test_aspect_ratio_study_matches_jax(tmp_path):
    depths = [0.25, 0.5]
    rows, stats = tphase_a.run_aspect_ratio_analysis(
        "cpu", H, base_dir=str(tmp_path / "port"), depths=depths,
        verbose=False)
    df = jphase_a.run_aspect_ratio_analysis(
        H, base_dir=str(tmp_path / "jax"), depths=depths, verbose=False)
    assert len(rows) == 6 and rows[-1]["Width"] == 1.0
    written = _read(tmp_path / "port" / "Aspect Ratio Study Analysis"
                    / "aspect_ratio_analysis_results.csv")
    _hold(written, rows, df, EXAMPLES / "phase_a_tpu_h0.02"
          / "Aspect Ratio Study Analysis"
          / "aspect_ratio_analysis_results.csv")
    _check_stats(stats)


def test_aspect_ratio_depths_match_jax():
    assert tphase_a.aspect_ratio_depths() == jphase_a.aspect_ratio_depths()
    assert tphase_a.ASPECT_RATIOS == jphase_a.ASPECT_RATIOS
    # widths above 1 mm are skipped: the full ladder gives the artifact's
    # 54 rows
    n = sum(h / ar <= 1.0 for ar in tphase_a.ASPECT_RATIOS.values()
            for h in tphase_a.aspect_ratio_depths())
    golden = _read(EXAMPLES / "phase_a_tpu_h0.02"
                   / "Aspect Ratio Study Analysis"
                   / "aspect_ratio_analysis_results.csv")
    assert n == len(golden) == 54


def test_geometry_study_matches_jax(tmp_path):
    geoms = ["square_medium", "reference"]
    rows, stats = tphase_a.run_geometry_analysis(
        "cpu", mesh_size_dim=H, base_dir=str(tmp_path / "port"),
        geometries=geoms, verbose=False)
    df = jphase_a.run_geometry_analysis(
        mesh_size_dim=H, base_dir=str(tmp_path / "jax"), geometries=geoms,
        verbose=False)
    assert len(rows) == 6
    assert sorted({r["Geometry_Name"] for r in rows}) == sorted(geoms)
    written = _read(tmp_path / "port" / "Geometry Analysis Analysis"
                    / "geometry_analysis_results.csv")
    _hold(written, rows, df, EXAMPLES / "phase_a_tpu_h0.02"
          / "Geometry Analysis Analysis" / "geometry_analysis_results.csv")
    _check_stats(stats)


def test_mu_eff_study_matches_jax(tmp_path):
    rows, stats = tphase_a.run_mu_eff_analysis(
        "cpu", mesh_size_dim=H, base_dir=str(tmp_path / "port"),
        verbose=False)
    df = jphase_a.run_mu_eff_analysis(
        mesh_size_dim=H, base_dir=str(tmp_path / "jax"), verbose=False)
    written = _read(tmp_path / "port" / "Mu_Eff Spatial Analysis Analysis"
                    / "mu_eff_analysis_results.csv")
    _hold(written, rows, df, EXAMPLES / "phase_a_tpu_h0.02"
          / "Mu_Eff Spatial Analysis Analysis"
          / "mu_eff_analysis_results.csv")
    _check_stats([stats])
    assert len(rows) == 3 and len(eval(rows[0]["Mu_X_Array"])) == 100


def test_sample_mu_along_bottom_matches_jax():
    from fenics_eff_uptake_tpu.analysis.mu_eff import \
        sample_mu_along_bottom as j_sample
    from types import SimpleNamespace
    mesh = SimpleNamespace(vertices=np.array([[0.0, 0.0], [10.0, 1.0],
                                              [3.0, -1.0]]))
    step = StepUptakeOpen(mu_base=1.0, mu_eff_target=3.5, sulcus_left_x=4.75,
                          sulcus_right_x=5.25, L_c=0.05, Gamma=5.0)
    for mu in (0.7, step):
        p = SimpleNamespace(mu=mu)
        got = sample_mu_along_bottom(p, mesh, n_points=200)
        ref = j_sample(p, mesh, n_points=200)
        assert got.keys() == ref.keys()
        np.testing.assert_array_equal(got["x"], ref["x"])
        np.testing.assert_array_equal(got["mu"], ref["mu"])
        for k in ("mu_mean", "mu_min", "mu_max"):
            assert got[k] == pytest.approx(ref[k], rel=1e-14)
    assert got["mu_max"] > 3.0 and got["mu_min"] == 1.0


def test_phase_b_study_matches_jax(tmp_path):
    geoms = ["square_medium", "reference"]
    rows, stats = tphase_b.run_no_adv_mu_sweep(
        "cpu", str(tmp_path / "port"), H, geometries=geoms, verbose=False)
    df = jphase_b.run_no_adv_mu_sweep(
        str(tmp_path / "jax"), H, geometries=geoms, verbose=False)
    assert len(rows) == 6
    # sorted by mu factor, then geometry
    assert [(r["mu_factor"], r["geometry"]) for r in rows] == sorted(
        (m, g) for m in tphase_b.MU_FACTORS for g in geoms)
    written = _read(tmp_path / "port" / "mu Sweep Analysis"
                    / tphase_b.CSV_NAME)
    _hold(written, rows, df, EXAMPLES / "phase_b_tpu_h0.02"
          / "no_adv_mu_sweep_results.csv", abs_cols=("flux_error_pct",))
    _check_stats(stats)
    assert [s["domain"] for s in stats] == ["sulcus", "rectangular"] * 2
    assert all(0.5 < r["CR"] < 1.1 for r in rows)

"""The port's figures (``plotting/``) against the JAX package's, on the CPU.

Every figure here is drawn at 40 dpi by both packages: the resolution
changes no file name, and it keeps the rendering short.

* The five checks of ``tests/test_plotting.py`` on port inputs (the
  adv-diff figure test slow, as there), each also held to the JAX
  function's file names on the same data.
* Every study plotting function writes the file names its JAX counterpart
  writes on the same rows: the port's takes the rows as a list of dicts
  (what the studies' ``save_csv`` returns), JAX's the DataFrame of them.
  The rows come from the committed artifacts in ``examples/`` (Phase A
  with ``Mu_Eff_Sim`` added, which the committed sweep lacks and the
  correlation figures need).
* ``replot_from_csv`` of each study, through the port's CLI, on a copy of
  the committed artifact without its figures, writes the file set JAX's
  writes on an identical copy (Phase B and adv-diff here; Phase A and
  no-uptake, heavier, in ``tests/test_torch_plotting_slow.py``).
* ``Table`` types columns as pandas does, from rows and from a CSV (the
  figures' file names carry the values as ``str``).
* Without matplotlib (``sys.modules["matplotlib"] = None``) a coarse
  Phase-B study still writes its CSV and prints one skip line, and
  ``run_simulation(plot=True)`` raises the ImportError.
"""

import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from fenics_eff_uptake_tpu.plotting import style as jstyle
from fenics_eff_uptake_tpu_torch.plotting import style as tstyle
from fenics_eff_uptake_tpu_torch.plotting.table import Table

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
EX = ROOT / "examples"
PHASE_A = EX / "phase_a_tpu_h0.02"
MESH_KW = dict(width=5.0, height=1.0, sulcus_depth=0.5, sulcus_width=0.5,
               mesh_size=0.15, refinement_factor=1, domain_type="sulcus")


class P:
    L, H = 5.0, 1.0
    sulci_h, sulci_w = 0.5, 0.5
    mu = 1.0
    mode = "no-adv"


class PNoU:
    mode = "no-uptake"


def _results(pkg):
    """The results dict of tests/test_plotting.py's fixture, computed by
    ``pkg`` ("jax" or "port")."""
    if pkg == "jax":
        from fenics_eff_uptake_tpu.analysis.flux import compute_flux_metrics
        from fenics_eff_uptake_tpu.analysis.mass import compute_mass_metrics
        from fenics_eff_uptake_tpu.analysis.mu_eff import \
            compute_mu_eff_metrics
        from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
        from fenics_eff_uptake_tpu.models.diffusion import \
            pure_diffusion_solve
        md = generate_mesh(**MESH_KW)
        c = pure_diffusion_solve(md, D=1.0, mu=1.0)
    else:
        from fenics_eff_uptake_tpu_torch.analysis.flux import \
            compute_flux_metrics
        from fenics_eff_uptake_tpu_torch.analysis.mass import \
            compute_mass_metrics
        from fenics_eff_uptake_tpu_torch.analysis.mu_eff import \
            compute_mu_eff_metrics
        from fenics_eff_uptake_tpu_torch.meshing.generator import \
            generate_mesh
        from fenics_eff_uptake_tpu_torch.models.diffusion import \
            pure_diffusion_solve
        md = generate_mesh(**MESH_KW)
        c = pure_diffusion_solve(md, "cpu", D=1.0, mu=1.0)
    fm = compute_flux_metrics(c, None, md, "sulcus", 1.0, 1.0, warn=False)
    return {
        "c": c, "u": None, "p": None,
        "mesh_results": {"mesh": md},
        "flux_metrics": fm,
        "mass_metrics": compute_mass_metrics(c, md, "sulcus"),
        "mu_eff_comparison": compute_mu_eff_metrics(c, md, P, fm),
        "params": P,
    }


@pytest.fixture(scope="module")
def sim_results():
    return _results("port")


@pytest.fixture(scope="module")
def jax_results():
    return _results("jax")


@pytest.fixture(autouse=True)
def low_dpi(monkeypatch):
    for cfg in (jstyle.Config, tstyle.Config):
        monkeypatch.setattr(cfg, "DPI", 40)


def _names(d):
    d = Path(d)
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


# ---------------------------------------------------------------------------
# the checks of tests/test_plotting.py, on the port
# ---------------------------------------------------------------------------

def test_plot_single_simulation_matches_jax(sim_results, jax_results,
                                            tmp_path):
    from fenics_eff_uptake_tpu.plotting.single import \
        plot_single_simulation as jplot
    from fenics_eff_uptake_tpu_torch.plotting.single import \
        plot_single_simulation
    plot_single_simulation(sim_results, str(tmp_path / "t"))
    pngs = [f for f in os.listdir(tmp_path / "t") if f.endswith(".png")]
    assert len(pngs) >= 7, pngs
    assert "concentration_field.png" in pngs
    assert "mu_eff_methods.png" in pngs
    jplot(jax_results, str(tmp_path / "j"))
    assert _names(tmp_path / "t") == _names(tmp_path / "j")


PHASE_B_ROWS = [
    {"geometry": g, "width_mm": w, "depth_mm": d, "mu_factor": mu,
     "CR": cr, "flux_ratio": fr, "flux_error_pct": fe}
    for (g, w, d), (mu, cr, fr, fe) in zip(
        [("a", 0.5, 0.5), ("b", 1.0, 0.2), ("c", 0.3, 1.0)] * 2,
        [(0.1, 0.97, 0.99, -1.0), (0.1, 0.99, 1.0, 0.2),
         (0.1, 0.95, 0.97, -2.5), (1.0, 0.9, 0.96, -3.0),
         (1.0, 0.93, 0.98, -1.5), (1.0, 0.88, 0.94, -5.0)])]


def test_phase_b_heatmaps_match_jax(tmp_path):
    from fenics_eff_uptake_tpu.plotting.phase_b_plots import \
        create_heatmaps as jheat
    from fenics_eff_uptake_tpu_torch.plotting.phase_b_plots import \
        create_heatmaps
    create_heatmaps(PHASE_B_ROWS, str(tmp_path / "t"))
    pngs = [f for f in os.listdir(tmp_path / "t") if f.endswith(".png")]
    assert len(pngs) == 6
    jheat(pd.DataFrame(PHASE_B_ROWS), str(tmp_path / "j"))
    assert _names(tmp_path / "t") == _names(tmp_path / "j")


def _advdiff_rows():
    rows = []
    for pe in (0.1, 1.0):
        for mf in (0.1, 1.0):
            rows.append({"Pe": pe, "mu_factor": mf,
                         "domain_type": "sulcus",
                         "mu_eff_open": 1.5 * mf, "flux_error_pct": np.nan,
                         "CR": np.nan, "Domain_Length_mm": 10.0,
                         "Sulcus_Width_mm": 0.5})
            rows.append({"Pe": pe, "mu_factor": mf,
                         "domain_type": "rectangular",
                         "mu_eff_open": 1.5 * mf,
                         "flux_error_pct": 0.1 * mf, "CR": 0.97,
                         "Domain_Length_mm": np.nan,
                         "Sulcus_Width_mm": np.nan})
    return rows


@pytest.mark.slow  # ~12 s of matplotlib rendering, as in test_plotting.py
def test_advdiff_validation_plots(tmp_path):
    from fenics_eff_uptake_tpu.plotting.adv_diff_plots import \
        create_validation_plots as jplots
    from fenics_eff_uptake_tpu_torch.plotting.adv_diff_plots import \
        create_validation_plots
    create_validation_plots(_advdiff_rows(), str(tmp_path / "t"))
    assert os.path.exists(tmp_path / "t" / "validation_heatmaps.png")
    assert os.path.exists(tmp_path / "t" / "mu_step_profiles_grid.png")
    jplots(pd.DataFrame(_advdiff_rows()), str(tmp_path / "j"))
    assert _names(tmp_path / "t") == _names(tmp_path / "j")


def test_comparison_and_summary_match_jax(sim_results, jax_results, tmp_path):
    from fenics_eff_uptake_tpu.plotting.comparison import \
        plot_configuration_comparison as jcompare
    from fenics_eff_uptake_tpu_torch.plotting.comparison import (
        plot_configuration_comparison, save_summary)
    rd = {"cfg_a": sim_results, "cfg_b": sim_results}
    plot_configuration_comparison(rd, str(tmp_path / "t"))
    for name in ("compare_total_mass", "flux_comparison",
                 "mu_eff_comparison", "mu_eff_ratios_comparison"):
        assert os.path.exists(tmp_path / "t" / f"{name}.png"), name
    assert os.path.exists(tmp_path / "t" / "comparison_summary.json")
    s = save_summary(rd, str(tmp_path / "summary.json"))
    assert s["cfg_a"]["mu_eff_sim"] is not None
    # the JAX package's files, and on the same results its summary text
    jd = {"cfg_a": jax_results, "cfg_b": jax_results}
    jcompare(jd, str(tmp_path / "j"))
    assert _names(tmp_path / "t") == _names(tmp_path / "j")
    plot_configuration_comparison(jd, str(tmp_path / "t2"))
    assert (tmp_path / "t2" / "comparison_summary.json").read_text() == \
        (tmp_path / "j" / "comparison_summary.json").read_text()


def test_comparison_no_uptake_drops_uptake_panels(sim_results, tmp_path):
    from fenics_eff_uptake_tpu_torch.plotting.comparison import (
        plot_flux_comparison, plot_mu_eff_comparison,
        plot_mu_eff_ratios_comparison)
    r = dict(sim_results)
    r["params"] = PNoU
    rd = {"cfg": r}
    plot_flux_comparison(rd, str(tmp_path))
    plot_mu_eff_comparison(rd, str(tmp_path))
    plot_mu_eff_ratios_comparison(rd, str(tmp_path))
    assert os.path.exists(tmp_path / "flux_comparison.png")
    assert not os.path.exists(tmp_path / "mu_eff_comparison.png")
    assert not os.path.exists(tmp_path / "mu_eff_ratios_comparison.png")


# ---------------------------------------------------------------------------
# every study plotting function: the JAX file names on the same rows
# ---------------------------------------------------------------------------

def _frame(csv):
    df = pd.read_csv(csv)
    if "Mu_Eff_Simulation" in df:
        df["Mu_Eff_Sim"] = df["Mu_Eff_Simulation"]
    return df


_A = {"sweep": PHASE_A / "Mu Parameter Sweep Analysis"
      / "mu_parameter_sweep_results.csv",
      "ar": PHASE_A / "Aspect Ratio Study Analysis"
      / "aspect_ratio_analysis_results.csv",
      "geom": PHASE_A / "Geometry Analysis Analysis"
      / "geometry_analysis_results.csv",
      "mu_eff": PHASE_A / "Mu_Eff Spatial Analysis Analysis"
      / "mu_eff_analysis_results.csv"}
# the study figures whose rendering takes a few seconds or less; the heavier
# ones are in test_torch_plotting_slow.py
STUDY_FIGURES = [
    ("phase_a_plots", "plot_mu_sweep", _A["sweep"]),
    ("phase_a_plots", "plot_mu_sweep_correlation", _A["sweep"]),
    ("phase_a_plots", "plot_mu_sweep_abs_error", _A["sweep"]),
    ("phase_a_plots", "plot_aspect_ratio", _A["ar"]),
    ("phase_a_plots", "plot_aspect_ratio_subplots", _A["ar"]),
    ("phase_a_plots", "plot_model_error_comparison", _A["ar"]),
    ("phase_a_plots", "plot_geometry_analysis", _A["geom"]),
    ("phase_a_plots", "plot_mu_eff_spatial", _A["mu_eff"]),
]


def figures_match_jax_names(tmp_path, module, name, csv):
    """The JAX function on the CSV's DataFrame and the port's on its
    rows write the same file names."""
    import importlib
    jfn = getattr(importlib.import_module(
        f"fenics_eff_uptake_tpu.plotting.{module}"), name)
    tfn = getattr(importlib.import_module(
        f"fenics_eff_uptake_tpu_torch.plotting.{module}"), name)
    df = _frame(csv)
    jfn(df, str(tmp_path / "j"))
    tfn(df.to_dict("records"), str(tmp_path / "t"))
    names = _names(tmp_path / "j")
    assert names, "the JAX function wrote nothing"
    assert _names(tmp_path / "t") == names


@pytest.mark.parametrize("module,name,csv", STUDY_FIGURES,
                         ids=[n for _, n, _ in STUDY_FIGURES])
def test_study_figures_match_jax_names(tmp_path, module, name, csv):
    figures_match_jax_names(tmp_path, module, name, csv)


def test_profile_grid_matches_jax_names(tmp_path):
    from fenics_eff_uptake_tpu.plotting.no_uptake_plots import \
        plot_profiles_grid_from_samples_csv as jgrid
    from fenics_eff_uptake_tpu_torch.plotting.no_uptake_plots import \
        plot_profiles_grid_from_samples_csv
    src = (EX / "no_uptake_tpu_h0.02" / "Geometry Comparison Analysis"
           / "Profiles" / "profiles_samples_square_small.csv")
    for side in ("j", "t"):
        (tmp_path / side).mkdir()
        shutil.copy(src, tmp_path / side)
    jgrid(str(tmp_path / "j" / src.name))
    plot_profiles_grid_from_samples_csv(str(tmp_path / "t" / src.name))
    assert _names(tmp_path / "t") == _names(tmp_path / "j")
    assert "Grids/profiles_grid_square_small.png" in _names(tmp_path / "t")


# ---------------------------------------------------------------------------
# replot_from_csv of each study (through the port's CLI) on a copy of the
# committed artifact, against JAX's on an identical copy
# ---------------------------------------------------------------------------

def _copy_artifact(study, dst):
    """The artifact without its figures; the adv-diff CSV goes under
    ``Results Data/``, where the study writes it."""
    if study == "adv_diff":
        (dst / "Results Data").mkdir(parents=True)
        shutil.copy(TABLE_CSVS["advdiff"], dst / "Results Data")
        return
    src = {"phase_a": PHASE_A, "phase_b": EX / "phase_b_tpu_h0.02",
           "no_uptake": EX / "no_uptake_tpu_h0.02"}[study]
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("*.png",
                                                            "*.pdf"))


def replot_matches_jax(tmp_path, study):
    import importlib
    jmod = importlib.import_module(f"fenics_eff_uptake_tpu.studies.{study}")
    tmod = importlib.import_module(
        f"fenics_eff_uptake_tpu_torch.studies.{study}")
    j, t = tmp_path / "j", tmp_path / "t"
    _copy_artifact(study, j)
    _copy_artifact(study, t)
    before = _names(t)
    jmod.replot_from_csv(str(j))
    flag = {"phase_a": "--base-dir", "no_uptake": "--base-dir"}.get(
        study, "--output-base")
    tmod.main((["--study", "replot"] if study == "phase_a" else ["replot"])
              + [flag, str(t)])
    assert len(_names(j)) > len(before), "JAX's replot wrote nothing"
    assert _names(t) == _names(j)


@pytest.mark.parametrize("study", ["phase_b", "adv_diff"])
def test_replot_matches_jax(tmp_path, study):
    replot_matches_jax(tmp_path, study)


def test_replot_without_a_csv_says_so(tmp_path, capsys):
    from fenics_eff_uptake_tpu_torch.studies import (adv_diff, no_uptake,
                                                     phase_a, phase_b)
    assert phase_b.replot_from_csv(str(tmp_path)) is None
    assert no_uptake.replot_from_csv(str(tmp_path)) is None
    assert adv_diff.replot_from_csv(str(tmp_path)) is None
    assert phase_a.replot_from_csv(str(tmp_path)) == []
    out = capsys.readouterr().out
    assert out.count("No CSV at") == 3 and "No CSV files found." in out


# ---------------------------------------------------------------------------
# Table: pandas' column types
# ---------------------------------------------------------------------------

def _kind(dtype):
    """int, float or object (pandas' string dtypes count as object)."""
    if pd.api.types.is_integer_dtype(dtype):
        return "int"
    if pd.api.types.is_float_dtype(dtype):
        return "float"
    return "object"


TABLE_CSVS = {
    **_A,
    "phase_b": EX / "phase_b_tpu_h0.02" / "mu Sweep Analysis"
    / "no_adv_mu_sweep_results.csv",
    "no_uptake": EX / "no_uptake_tpu_h0.02" / "Geometry Comparison Analysis"
    / "geometry_comparison_results.csv",
    "advdiff": EX / "advdiff_h0.12" / "advdiff_validation_step_pe_x_mu.csv",
}


@pytest.mark.parametrize("csv", list(TABLE_CSVS.values()),
                         ids=list(TABLE_CSVS))
def test_table_types_columns_as_pandas(csv):
    # the round-trip parser: pandas' default one can read a decimal one ulp
    # away from the float it names
    df = pd.read_csv(csv, float_precision="round_trip")
    for t in (Table.read_csv(csv), Table.from_rows(df.to_dict("records"))):
        assert list(t.columns) == list(df.columns)
        for col in df.columns:
            assert _kind(t[col].dtype) == _kind(df[col].dtype), col
            np.testing.assert_array_equal(t.notna(col), df[col].notna(), col)
            if _kind(df[col].dtype) != "object":
                np.testing.assert_array_equal(t[col], df[col].to_numpy(),
                                              col)


def test_table_from_rows_types_as_pandas():
    rows = [{"i": 1, "f": 1, "s": "a", "n": None},
            {"i": 2, "f": 2.5, "s": None, "n": None, "late": 3}]
    t = Table.from_rows(rows)
    df = pd.DataFrame(rows)
    assert list(t.columns) == list(df.columns)
    for col in ("i", "f", "s", "late"):
        assert _kind(t[col].dtype) == _kind(df[col].dtype), col
        np.testing.assert_array_equal(t.notna(col), df[col].notna(), col)
    assert [str(v) for v in t.unique("i")] == ["1", "2"]
    assert [str(v) for v in t.unique("f")] == ["1.0", "2.5"]


# ---------------------------------------------------------------------------
# without matplotlib
# ---------------------------------------------------------------------------

def test_phase_b_study_without_matplotlib(tmp_path, monkeypatch, capsys):
    from fenics_eff_uptake_tpu_torch.studies.phase_b import (
        CSV_NAME, run_no_adv_mu_sweep)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    rows, _ = run_no_adv_mu_sweep("cpu", str(tmp_path), 0.2,
                                  mu_factors=[0.1, 1.0],
                                  geometries=["reference"], verbose=False)
    assert len(rows) == 2
    study = tmp_path / "mu Sweep Analysis"
    assert (study / CSV_NAME).exists()
    assert not (study / "Plots").exists()
    skipped = [line for line in capsys.readouterr().out.splitlines()
               if "plots skipped" in line]
    assert skipped == ["  plots skipped (Phase-B heatmaps): matplotlib is "
                       "not installed"]


def test_run_simulation_plot_needs_matplotlib(tmp_path, monkeypatch):
    from fenics_eff_uptake_tpu_torch.params import Parameters
    from fenics_eff_uptake_tpu_torch.simulation import run_simulation
    p = Parameters(mode="no-adv", L_dim=5.0, H_dim=1.0, sulci_w_dim=0.5,
                   sulci_h_dim=0.5, mesh_size_dim=0.2)
    p.validate()
    p.nondim()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        run_simulation("no-adv", "T", "c", "sulcus", p, device="cpu",
                       results_root=str(tmp_path), plot=True, verbose=False)

"""The heavier figure checks of ``tests/test_torch_plotting.py`` (the
same criteria: the JAX package's file names on the same data, both at 40
dpi), each taking 5-25 s of matplotlib rendering: the Phase-A and no-uptake
replots, and the study figures with the most panels, on the committed
artifacts."""

import pandas as pd
import pytest

from test_torch_plotting import (EX, _A, _names, figures_match_jax_names,
                                 low_dpi, replot_matches_jax)  # noqa: F401

HEAVY_FIGURES = [
    ("phase_a_plots", "plot_geometry_error_grids", _A["geom"]),
    ("phase_b_plots", "create_heatmaps", EX / "phase_b_tpu_h0.02"
     / "mu Sweep Analysis" / "no_adv_mu_sweep_results.csv"),
    ("no_uptake_plots", "generate_all_plots", EX / "no_uptake_tpu_h0.02"
     / "Geometry Comparison Analysis" / "geometry_comparison_results.csv"),
]


@pytest.mark.slow
@pytest.mark.parametrize("module,name,csv", HEAVY_FIGURES,
                         ids=[n for _, n, _ in HEAVY_FIGURES])
def test_heavy_study_figures_match_jax_names(tmp_path, low_dpi, module, name,
                                             csv):
    figures_match_jax_names(tmp_path, module, name, csv)


@pytest.mark.slow
def test_advdiff_figures_match_jax_names_on_the_artifact(tmp_path, low_dpi):
    from fenics_eff_uptake_tpu.plotting.adv_diff_plots import \
        create_validation_plots as jplots
    from fenics_eff_uptake_tpu_torch.plotting.adv_diff_plots import \
        create_validation_plots
    df = pd.read_csv(EX / "advdiff_h0.12"
                     / "advdiff_validation_step_pe_x_mu.csv")
    jplots(df, str(tmp_path / "j"))
    create_validation_plots(df.to_dict("records"), str(tmp_path / "t"))
    assert _names(tmp_path / "t") == _names(tmp_path / "j")


@pytest.mark.slow
@pytest.mark.parametrize("study", ["phase_a", "no_uptake"])
def test_heavy_replot_matches_jax(tmp_path, low_dpi, study):
    replot_matches_jax(tmp_path, study)

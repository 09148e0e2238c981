"""The port's no-uptake study driver against the JAX package's, on the CPU.

* ``run_geometry_study(["square_small"], Pe = [0.1, 1.0])`` at h = 0.07,
  fine enough for both packages to take the multigrid path (h < 0.08),
  against the JAX study in its CPU configuration (f64 MINRES Stokes, f64
  BiCGStab); the JAX profile CSVs and plots, which the port does not have
  yet, are switched off.  Same columns in the same order, same empty cells,
  every number to 1e-8 relative, except the signed net fluxes
  (Inlet-Outlet Flux, Mouth_Flux_Total, Mouth Net Check): they are
  differences of O(1) boundary fluxes, so their error is the fluxes'
  (both Stokes solves stop at a relative residual of 1e-9) and they are
  held to 1e-9 absolute.
* ``add_ratio_metrics`` (plain Python) against the JAX one (pandas) on the
  same rows, including a Pe without a rectangle row.
* The port's CSV header is the committed artifact's.
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu.studies import no_uptake as jnu
from fenics_eff_uptake_tpu_torch.studies import no_uptake as tnu

torch.set_num_threads(2)

GOLDEN = (Path(__file__).resolve().parents[1] / "examples"
          / "no_uptake_tpu_h0.02" / "Geometry Comparison Analysis"
          / "geometry_comparison_results.csv")
CSV = "Geometry Comparison Analysis/geometry_comparison_results.csv"
NET_FLUXES = ("Inlet-Outlet Flux", "Mouth_Flux_Total", "Mouth Net Check")


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    base = tmp_path_factory.mktemp("nu")
    _, stats = tnu.run_geometry_study(["square_small"], [0.1, 1.0], 0.07,
                                      base_dir=str(base / "port"),
                                      device="cpu", verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEU_DISK_CACHE", "0")
        mp.setattr(jnu, "PROFILE_GEOMETRIES", [])
        from fenics_eff_uptake_tpu.plotting import no_uptake_plots
        mp.setattr(no_uptake_plots, "generate_all_plots",
                   lambda *a, **k: None)
        jnu.run_geometry_study([0.1, 1.0], 0.07, geometries=["square_small"],
                               base_dir=str(base / "jax"), verbose=False)
    return stats, _read(base / "port" / CSV), _read(base / "jax" / CSV)


def test_no_uptake_study_matches_jax(studies):
    stats, got, ref = studies
    assert [s["geometry"] for s in stats] == ["square_small", "rectangle"]
    assert all(s["multilevel"] for s in stats)
    for s in stats:
        assert s["stokes_rel_resnorm"] <= 1e-9
        assert max(s["rel_resnorm"]) <= 1e-12
    assert list(got[0]) == list(ref[0])
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        for k in r:
            if r[k] == "" or k in ("Domain", "Mode"):
                assert g[k] == r[k], k
                continue
            gv, rv = float(g[k]), float(r[k])
            tol = 1e-9 if k in NET_FLUXES else 1e-8 * abs(rv)
            assert abs(gv - rv) <= tol, (g["Domain"], g["Peclet"], k, gv, rv)


def test_no_uptake_header_is_the_artifacts(studies):
    with open(GOLDEN, newline="") as f:
        golden = next(csv.reader(f))
    assert list(studies[1][0]) == golden


def test_add_ratio_metrics_matches_jax():
    import pandas as pd
    rng = np.random.default_rng(9)
    cols = ["Avg Concentration", "Main Channel Avg Concentration",
            "Sulcus Avg Concentration", "Max_Ux_mid_channel",
            "Avg_Ux_mid_channel", "Max_Ux_sulcus_level",
            "Avg_Ux_sulcus_level"]
    rows = []
    for dom, pe in (("sulcus", 0.1), ("sulcus", 1.0), ("sulcus", 10.0),
                    ("rectangle", 0.1), ("rectangle", 1.0)):
        rows.append({"Domain": dom, "Peclet": pe,
                     **{c: float(rng.random()) + 0.5 for c in cols}})
    ref = jnu.add_ratio_metrics(pd.DataFrame(rows))
    got = tnu.add_ratio_metrics([dict(r) for r in rows])
    for i, g in enumerate(got):
        for c in tnu.RATIO_COLUMNS:
            rv = ref[c].iloc[i]
            if np.isnan(rv):
                assert g[c] is None, (i, c)
            else:
                assert g[c] == pytest.approx(rv, rel=1e-15), (i, c)

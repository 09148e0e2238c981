"""The port's adv-diff step-mu study against the JAX package's.

``run_advdiff_step_validation`` on a 2 x 2 subset of the Pe x mu grid at
h = 0.15 (no hierarchy on either side: Jacobi-preconditioned BiCGStab, the
port in mixed precision, JAX's CPU default in f64, both to rtol 1e-12):
the CSV row for row at 1e-7 relative (differences of fluxes, the
rectangle's ``advective_flux`` and ``flux_error_pct``: 1e-7 of the total
flux), the header equal to the committed artifact's.
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu.studies import adv_diff as jadv
from fenics_eff_uptake_tpu_torch.studies import adv_diff as tadv

torch.set_num_threads(2)

GOLDEN = (Path(__file__).resolve().parents[1] / "examples"
          / "advdiff_tpu_h0.02" / "Results Data"
          / "advdiff_validation_step_pe_x_mu.csv")


def test_advdiff_study_matches_jax(tmp_path):
    """The study's CSV on a 2 x 2 subset of the grid at h = 0.15 against
    JAX's, row for row; the header is the artifact's."""
    kw = dict(mesh_size_dim=0.15, pe_values=[1.0, 10], mu_factors=[0.1, 10],
              verbose=False)
    rows, stats = tadv.run_advdiff_step_validation(
        str(tmp_path / "port"), device="cpu", **kw)
    df = jadv.run_advdiff_step_validation(str(tmp_path / "jax"), **kw)
    with open(tmp_path / "port" / "Results Data" / tadv.CSV_NAME,
              newline="") as f:
        written = list(csv.DictReader(f))
    with open(GOLDEN, newline="") as f:
        golden = list(csv.DictReader(f))
    assert list(written[0]) == list(golden[0]) == list(df.columns)
    assert len(written) == len(rows) == len(df) == 8
    assert [s["domain"] for s in stats] == ["sulcus", "rectangular"]
    for s in stats:
        assert max(s["rel_resnorm"]) <= 1e-11
        assert s["stokes_rel_resnorm"] <= 1e-9
    for i, (w, r) in enumerate(zip(written, rows)):
        ref = df.iloc[i]
        scale = abs(float(ref["total_flux"]))
        for col in golden[0]:
            if col in ("domain_type", "surrogate_type"):
                assert w[col] == r[col] == ref[col]
                continue
            if w[col] == "":
                assert r.get(col) is None and np.isnan(ref[col]), (i, col)
                continue
            assert float(w[col]) == r[col]
            if col in ("advective_flux", "flux_error_pct"):
                # differences of fluxes (flux_error_pct in percent)
                tol = 1e-7 * scale * (100.0 / scale
                                      if col == "flux_error_pct" else 1.0)
                assert abs(r[col] - ref[col]) <= tol, (i, col)
            else:
                assert r[col] == pytest.approx(ref[col], rel=1e-7), (i, col)
    rect = [r for r in rows if r["domain_type"] == "rectangular"]
    assert all(abs(r["flux_error_pct"]) < 10.0 for r in rect)
    assert all(0.8 < r["CR"] < 1.05 for r in rect)
    assert (tmp_path / "port" / "Results Data"
            / "study_metadata.json").exists()

"""The port's Phase-A study driver on the CPU.

* ``no_adv_batch`` against the JAX package's on a coarse mesh (h = 0.15,
  where neither builds a hierarchy): the CSV columns to 1e-7 relative,
  since both solve to rtol 1e-12, the port in mixed precision with Jacobi
  and the JAX CPU default in f64.
* ``run_mu_sweep`` writes the committed artifact's columns, 20 finite rows.
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu.studies import common as jcommon
from fenics_eff_uptake_tpu.studies import phase_a as jphase_a
from fenics_eff_uptake_tpu_torch.studies import common as tcommon
from fenics_eff_uptake_tpu_torch.studies import phase_a as tphase_a

torch.set_num_threads(2)

GOLDEN = (Path(__file__).resolve().parents[1] / "examples"
          / "phase_a_tpu_h0.02" / "Mu Parameter Sweep Analysis"
          / "mu_parameter_sweep_results.csv")
FACTORS = [0.1, 1.0, 10.0]


def _columns(results):
    return [jphase_a._mu_eff_columns(r) for r in results]


def test_no_adv_batch_matches_jax():
    geom = tcommon.make_no_adv_params(1.0, sulci_w_dim=0.25,
                                      sulci_h_dim=0.25, mesh_size_dim=0.15)
    got, stats = tcommon.no_adv_batch(geom, FACTORS, "sulcus", "cpu",
                                      verbose=False)
    ref = jcommon.no_adv_batch(geom, FACTORS, "sulcus", verbose=False)
    assert not stats["multilevel"]
    assert max(stats["rel_resnorm"]) <= 1e-12
    assert stats["cells"] == ref[0]["mesh_results"]["mesh"].num_cells
    for g, r in zip(_columns(got), _columns(ref)):
        assert g.keys() == r.keys()
        for k in r:
            assert g[k] == pytest.approx(r[k], rel=1e-7, abs=1e-12), k
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g["c"].values, np.asarray(r["c"].values),
                                   rtol=0, atol=1e-9)


def test_run_mu_sweep_writes_the_artifact_columns(tmp_path):
    rows, stats = tphase_a.run_mu_sweep("cpu", mesh_size_dim=0.15,
                                        base_dir=str(tmp_path),
                                        verbose=False)
    path = (tmp_path / "Mu Parameter Sweep Analysis"
            / "mu_parameter_sweep_results.csv")
    with open(path, newline="") as f:
        written = list(csv.DictReader(f))
    with open(GOLDEN, newline="") as f:
        golden = list(csv.DictReader(f))
    assert list(written[0]) == list(golden[0])
    assert [r["Config"] for r in written] == [r["Config"] for r in golden]
    for r, w in zip(rows, written):
        for col in ("Mu_Eff_Simulation", "Total_Mass", "Mouth_Flux_Total"):
            assert np.isfinite(float(w[col]))
            assert float(w[col]) == r[col]
    assert len(stats["iters"]) == 20
    assert (tmp_path / "Mu Parameter Sweep Analysis"
            / "study_metadata.json").exists()

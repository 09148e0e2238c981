"""The heavy rungs of the E_L1 ladder against the JAX script (marker
``slow``; rungs 1 and 2 are in ``test_torch_el1_convergence.py``).

The w0.4/d2.0 family: at h = 0.07, Pe 0.1 and 1, refinement factor 4
(5,670 cells, hmin 0.0125), and at h = 0.05, Pe 0.1, factor 16 (27,589
cells), whose mid-level restriction takes windows wider than the JAX
width menu: the port's ``run_factor`` against the JAX script's, the disk
cache off, each package in its CPU configuration, with the fast file's
tolerances (cells and hmin exactly, E_L1, Q_in and Q_out 1e-8 relative,
J_open_total 1e-9 absolute)."""

import pytest
import torch

from fenics_eff_uptake_tpu_torch.studies import el1_convergence as el

from test_torch_el1_convergence import H, PE, _load_script

torch.set_num_threads(2)


@pytest.mark.slow
def test_factor_four_rung_matches_the_jax_script(monkeypatch):
    jel = _load_script("el1_convergence")
    monkeypatch.setenv("FEU_DISK_CACHE", "0")
    port = el.run_factor(PE, 0.4, 2.0, H, 4, "cpu")
    el.release("cpu")
    ref = jel.run_factor(PE, 0.4, 2.0, H, 4)
    assert len(port) == len(ref) == 2
    for g, r in zip(port, ref):
        assert tuple(g) == el.ROW_KEYS == tuple(r)
        assert g["cells"] == r["cells"] == 5670
        assert g["hmin"] == r["hmin"]
        for k in ("E_L1", "Q_in", "Q_out"):
            assert abs(g[k] - r[k]) <= 1e-8 * abs(r[k]), (g["pe"], k)
        assert abs(g["J_open_total"] - r["J_open_total"]) <= 1e-9
        assert g["max_rel_resnorm"] <= 1e-12


@pytest.mark.slow
def test_widened_transfer_rung_matches_the_jax_script(monkeypatch):
    """A rung whose mid-level restriction needs windows past the JAX
    width menu (h = 0.05, factor 16: ``test_torch_graded_transfers.py``):
    the port's widened bands against the JAX script's gather transfers,
    at Pe 0.1, with the tolerances above."""
    jel = _load_script("el1_convergence")
    monkeypatch.setenv("FEU_DISK_CACHE", "0")
    port = el.run_factor([0.1], 0.4, 2.0, 0.05, 16, "cpu")
    el.release("cpu")
    ref = jel.run_factor([0.1], 0.4, 2.0, 0.05, 16)
    (g,), (r,) = port, ref
    assert g["cells"] == r["cells"] == 27589
    assert g["hmin"] == r["hmin"]
    for k in ("E_L1", "Q_in", "Q_out"):
        assert abs(g[k] - r[k]) <= 1e-8 * abs(r[k]), k
    assert abs(g["J_open_total"] - r["J_open_total"]) <= 1e-9
    assert g["max_rel_resnorm"] <= 1e-12

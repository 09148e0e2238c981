"""The port's mesh-convergence study and package menu against the JAX
package's.

``richardson`` equals JAX's on every branch.  The coarse ladder (h = 0.16,
0.11, 0.08: no hierarchy on either side; the port in mixed precision, JAX's
CPU default in f64, both to rtol 1e-12) with the realisation check: every
CSV row at the tolerance of tests/test_torch_noadv_studies.py (1e-7
relative), the header equal to the committed artifact's, the orders and
extrapolated limits to 1e-6 relative, the realisation floors (relative
differences themselves) to 1e-8 absolute.  ``main`` takes the coarse
ladder on ``--coarse``; the package menu lists the five studies and hands
each its arguments.
"""

import csv
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from fenics_eff_uptake_tpu.studies import mesh_convergence as jmc
from fenics_eff_uptake_tpu_torch import __main__ as tmain
from fenics_eff_uptake_tpu_torch.studies import mesh_convergence as tmc

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = (ROOT / "examples" / "mesh_convergence_tpu_h0.02"
          / "Mesh Convergence Analysis")
STUDY = "Mesh Convergence Analysis"


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@pytest.mark.parametrize("h, q", [
    ([0.08, 0.057, 0.04, 0.028, 0.02], [0.1069, 0.10708, 0.10722, 0.10731,
                                        0.107396]),
    ([0.16, 0.11, 0.08], [0.9, 0.95, 0.97]),
    ([0.16, 0.11, 0.08], [0.9, 0.95, 0.93]),      # not monotone
    ([0.16, 0.11, 0.08], [0.9, 0.95, 0.95]),      # d23 == 0
    ([0.16, 0.11, 0.08], [0.9, 0.95, 1.0]),       # r == 1
    ([0.11, 0.08], [0.95, 0.97]),                 # too short
    ([], []),
])
def test_richardson_equals_jax(h, q):
    assert tmc.richardson(h, q) == jmc.richardson(h, q)


def test_ladders_equal_jax():
    assert tmc.DEFAULT_LADDER == jmc.DEFAULT_LADDER


@pytest.fixture(scope="module")
def studies(tmp_path_factory):
    base = tmp_path_factory.mktemp("mc")
    tmc.run_mesh_convergence("cpu", ladder=tmc.COARSE_LADDER,
                             base_dir=str(base / "port"), verbose=False,
                             realisation_check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEU_DISK_CACHE", "0")
        from fenics_eff_uptake_tpu.plotting import style
        mp.setattr(style, "safe_plot", None)   # no plot: the port has none
        df = jmc.run_mesh_convergence(ladder=tmc.COARSE_LADDER,
                                      base_dir=str(base / "jax"),
                                      verbose=False, realisation_check=True)
    meta = [json.loads((base / pkg / STUDY / "study_metadata.json")
                       .read_text()) for pkg in ("port", "jax")]
    return (_read(base / "port" / STUDY / "mesh_convergence_results.csv"),
            df, *meta)


def test_mesh_convergence_rows_match_jax(studies):
    written, df, _, _ = studies
    golden = _read(GOLDEN / "mesh_convergence_results.csv")
    assert list(written[0]) == list(golden[0]) == list(df.columns)
    assert len(written) == len(df) == 9
    for i, w in enumerate(written):
        ref = df.iloc[i]
        for col in golden[0]:
            assert float(w[col]) == pytest.approx(
                float(ref[col]), rel=1e-7, abs=1e-12), (i, col)
    # sorted by mu factor, then h
    keys = [(float(w["mu_factor"]), float(w["mesh_size"])) for w in written]
    assert keys == sorted(keys)


def test_mesh_convergence_metadata_matches_jax(studies):
    _, _, got, want = studies
    assert sorted(got) == sorted(want)
    for k in ("study_type", "ladder", "mu_factors", "geometry_mm"):
        assert got[k] == want[k], k
    assert list(got["convergence"]) == list(want["convergence"])
    for mf, c in want["convergence"].items():
        g = got["convergence"][mf]
        assert g["order_estimate"] == pytest.approx(c["order_estimate"],
                                                    rel=1e-6)
        assert g["mu_eff_sim_extrapolated"] == pytest.approx(
            c["mu_eff_sim_extrapolated"], rel=1e-7)
    assert list(got["mesh_realisation_floor"]) == list(
        want["mesh_realisation_floor"])
    for mf, f in want["mesh_realisation_floor"].items():
        g = got["mesh_realisation_floor"][mf]
        assert list(g) == list(f)
        for k, v in f.items():
            assert abs(g[k] - v) <= 1e-8, (mf, k, g[k], v)
            assert g[k] > 0


def test_main_runs_the_coarse_ladder(monkeypatch):
    got = []
    monkeypatch.setattr(tmc, "run_mesh_convergence",
                        lambda *a, **k: got.append((a, k)))
    tmc.main(["--coarse", "--device", "cpu", "--base-dir", "out"])
    tmc.main([])
    assert got == [(("cpu",), {"ladder": tmc.COARSE_LADDER,
                               "base_dir": "out"}),
                   (("cuda",), {"ladder": None, "base_dir": tmc.BASE_DIR})]
    assert tmc.COARSE_LADDER == [0.16, 0.11, 0.08]


def test_menu_help_lists_the_five_studies():
    proc = subprocess.run([sys.executable, "-m",
                           "fenics_eff_uptake_tpu_torch", "--help"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    for key in ("phase-a", "phase-b", "no-uptake", "adv-diff",
                "mesh-convergence"):
        assert key in proc.stdout, key
    assert list(tmain.STUDIES) == ["phase-a", "phase-b", "no-uptake",
                                   "adv-diff", "mesh-convergence"]


@pytest.mark.parametrize("key", list(tmain.STUDIES))
def test_menu_dispatches_with_the_remaining_arguments(key, monkeypatch):
    import importlib
    mod = importlib.import_module(tmain.STUDIES[key][1])
    assert mod.__name__.startswith("fenics_eff_uptake_tpu_torch.studies.")
    got = []
    monkeypatch.setattr(mod, "main", got.append)
    tmain.main([key, "--device", "cpu", "--mesh-size", "0.1"])
    assert got == [["--device", "cpu", "--mesh-size", "0.1"]]


def test_menu_refuses_an_unknown_study(capsys):
    with pytest.raises(SystemExit) as e:
        tmain.main(["phase-c"])
    assert e.value.code == 2
    assert "unknown study" in capsys.readouterr().out

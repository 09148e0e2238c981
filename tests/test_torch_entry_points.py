"""The port's entry points beside the JAX system's, on the CPU.

* ``python -m fenics_eff_uptake_tpu_torch.bench --device cpu --mesh-size
  0.1`` prints one JSON line whose top-level keys and ``meta`` key names
  are ``bench.py``'s (read from its source: the JAX bench is not run),
  plus the port's declared extras; without a card and without ``--device
  cpu`` it prints ``bench.py``'s error line and exits 1.
* The artifact comparator (``studies/artifacts.py``, which
  ``chip_smoke.py`` and ``run_studies.py`` share) passes every committed
  ``examples/*_tpu_h0.02`` CSV (and the no-uptake profile CSVs and the
  convergence orders) against itself, and fails on a copy with one value
  moved by 2e-6 relative.
* ``run_studies.py phase_a_mu --device cpu --mesh-size 0.1`` writes its
  CSV under the given base; ``--check`` refuses another h than 0.02, and
  the runner's check passes on the artifacts' own directories.
"""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fenics_eff_uptake_tpu_torch import bench, run_studies
from fenics_eff_uptake_tpu_torch.studies import artifacts

ROOT = Path(__file__).resolve().parents[1]
CPU_ONLY = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
            "OMP_NUM_THREADS": "2"}


def _bench_py_keys():
    """(top-level keys, meta keys, meta keys set only for BENCH_PRECOND
    ml, error-line keys) of bench.py, from its source."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    meta, ml_only, dicts = set(), set(), []

    def walk(node, in_ml):
        for child in ast.iter_child_nodes(node):
            ml = in_ml or (isinstance(child, ast.If)
                           and "PRECOND" in ast.unparse(child.test)
                           and "'ml'" in ast.unparse(child.test))
            if isinstance(child, ast.Assign):
                t = child.targets[0]
                if isinstance(t, ast.Name) and t.id == "meta":
                    meta.update(k.value for k in child.value.keys)
                elif (isinstance(t, ast.Subscript)
                      and isinstance(t.value, ast.Name)
                      and t.value.id == "meta"):
                    (ml_only if ml else meta).add(t.slice.value)
            if isinstance(child, ast.Dict) and any(
                    isinstance(k, ast.Constant) and k.value == "metric"
                    for k in child.keys):
                dicts.append({k.value for k in child.keys})
            walk(child, ml)

    walk(tree, False)
    line = next(d for d in dicts if "meta" in d)
    error = next(d for d in dicts if "error" in d)
    return line, meta - ml_only, ml_only, error


def _run(args, timeout=300):
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout,
                          env=CPU_ONLY)


@pytest.mark.parametrize("precond", ["ml", "twolevel"])
def test_bench_line_has_bench_py_keys(precond):
    top, meta, ml_only, _ = _bench_py_keys()
    assert {"iters", "max_rel_resnorm", "backend"} <= meta
    assert ml_only == {"ml_cycle", "roofline"}
    proc = _run(["fenics_eff_uptake_tpu_torch.bench", "--device", "cpu",
                 "--mesh-size", "0.1", "--precond", precond])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    assert set(line) == top
    want = meta | set(bench.EXTRA_META) | (ml_only if precond == "ml"
                                           else set())
    assert set(line["meta"]) == want
    m = line["meta"]
    assert m["preconditioner"] == precond and m["backend"] == "cpu"
    assert m["card"] is None and m["n_sweep_points"] == bench.N_MU
    assert m["max_rel_resnorm"] <= bench.RTOL
    assert line["value"] > 0 and line["unit"] == "s/point"
    assert line["value"] == pytest.approx(
        (m["assembly_s"] + m["twolevel_setup_s"] + m["steady_solve_s"])
        / bench.N_MU)
    # every warm stage did its work anew: no memo hit in any stage
    for stage, recs in m["cache_stats"].items():
        for rec in recs:
            assert all(n.get("memo", 0) == 0 for n in rec.values()), (
                stage, rec)
    if precond == "ml":
        assert m["roofline"]["chip"] == "cpu"


def test_bench_refuses_without_a_card():
    _, _, _, error = _bench_py_keys()
    proc = _run(["fenics_eff_uptake_tpu_torch.bench", "--mesh-size", "0.1"])
    assert proc.returncode == 1
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(line) == error and line["value"] is None
    assert "CUDA" in line["error"]


def _artifact_dir(study):
    return artifacts.EXAMPLES / artifacts.ARTIFACTS[study].directory


@pytest.mark.parametrize("study", sorted(artifacts.ARTIFACTS))
def test_comparator_passes_each_artifact_against_itself(study):
    a = artifacts.ARTIFACTS[study]
    worst = artifacts.check_csv(study, _artifact_dir(study))
    assert set(a.rel) | set(a.absolute) <= set(worst)
    assert all(worst[c] == 0.0 for c in (*a.rel, *a.absolute))
    assert len(artifacts.read_rows(_artifact_dir(study) / a.csv)) == a.rows


def _moved_copy(tmp_path, study, col=None, rel=2e-6):
    """A copy of the study's artifact CSV under tmp_path with one value of
    a compared column moved by ``rel`` relative."""
    a = artifacts.ARTIFACTS[study]
    rows = artifacts.read_rows(_artifact_dir(study) / a.csv)
    col = col or a.rel[-1]
    i = next(i for i, r in enumerate(rows)
             if r[col] not in ("", None) and float(r[col]) != 0.0)
    rows[i][col] = repr(float(rows[i][col]) * (1.0 + rel))
    out = tmp_path / a.csv
    out.parent.mkdir(parents=True)
    with open(out, "w", newline="") as f:
        w = artifacts.csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    return rows


@pytest.mark.parametrize("study", sorted(artifacts.ARTIFACTS))
def test_comparator_fails_on_a_moved_value(tmp_path, study):
    _moved_copy(tmp_path, study)
    with pytest.raises(AssertionError, match="off the artifact"):
        artifacts.check_csv(study, tmp_path)
    # within the tolerance the copy passes
    shutil.rmtree(tmp_path)
    tmp_path.mkdir()
    _moved_copy(tmp_path, study, rel=5e-7)
    artifacts.check_csv(study, tmp_path)


def test_comparator_holds_the_scaled_columns(tmp_path):
    """An absolute column (the no-uptake net flux, over |Mouth Q_in|)
    moved by 2e-6 of its scale fails; the stale rows are reported."""
    a = artifacts.ARTIFACTS["no_uptake"]
    rows = artifacts.read_rows(_artifact_dir("no_uptake") / a.csv)
    r = next(r for r in rows if r["Domain"] == "sulcus")
    r["Mouth_Flux_Total"] = repr(float(r["Mouth_Flux_Total"])
                                 + 2e-6 * abs(float(r["Mouth Q_in"])))
    with pytest.raises(AssertionError, match="Mouth_Flux_Total"):
        artifacts.check_rows("no_uptake", rows)
    worst = artifacts.check_csv("no_uptake", _artifact_dir("no_uptake"))
    assert set(worst["stale"]) == {"micro_depth_wide", "micro_square"}
    # a row missing, or the full count of another subset, fails
    with pytest.raises(AssertionError):
        artifacts.check_rows("no_uptake", rows[1:])


def _nu_rows_with(key, col, delta):
    a = artifacts.ARTIFACTS["no_uptake"]
    rows = artifacts.read_rows(_artifact_dir("no_uptake") / a.csv)
    r = next(r for r in rows if artifacts.nu_key(r) == key)
    r[col] = repr(float(r[col]) + delta)
    return rows


def test_comparator_floors_the_net_flux_scale():
    """Below a mouth inflow of 1e-3 (micro_width_deep at Pe = 10: 3.6e-5)
    the net fluxes are held to 1e-9 absolute; the stale rows' errors are
    reported, not held."""
    micro = ("sulcus", 0.05, 1.0, 10.0)
    artifacts.check_rows("no_uptake", _nu_rows_with(
        micro, "Inlet-Outlet Flux", 5e-10))
    with pytest.raises(AssertionError, match="Inlet-Outlet Flux"):
        artifacts.check_rows("no_uptake", _nu_rows_with(
            micro, "Inlet-Outlet Flux", 2e-9))
    stale = ("sulcus", 1.0, 0.05, 10.0)
    worst = artifacts.check_rows("no_uptake", _nu_rows_with(
        stale, "Total Mass", 1e-3))
    assert worst["stale"]["micro_depth_wide"]["Total Mass"] > 1e-6


def test_comparator_profiles_and_orders(tmp_path):
    prof = (_artifact_dir("no_uptake") / "Geometry Comparison Analysis"
            / "Profiles")
    assert artifacts.check_profiles(prof)["c"] == 0.0
    copy = tmp_path / "Profiles"
    shutil.copytree(prof, copy)
    name = "profiles_samples_largest.csv"
    rows = artifacts.read_rows(copy / name)
    i = next(i for i, r in enumerate(rows) if float(r["c"]) > 0.1)
    rows[i]["c"] = repr(float(rows[i]["c"]) * (1 + 2e-6))
    with open(copy / name, "w", newline="") as f:
        w = artifacts.csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
    with pytest.raises(AssertionError, match="profile CSVs"):
        artifacts.check_profiles(copy)
    meta = json.loads((_artifact_dir("richardson")
                       / "Mesh Convergence Analysis"
                       / "study_metadata.json").read_text())
    assert max(artifacts.check_convergence(meta).values()) == 0.0
    k = next(iter(meta["convergence"]))
    meta["convergence"][k]["order_estimate"] *= 1 + 2e-4
    with pytest.raises(AssertionError, match="orders"):
        artifacts.check_convergence(meta)


@pytest.mark.parametrize("study", run_studies.STUDIES)
def test_runner_check_passes_on_the_artifacts(study):
    """The runner's check of one study, pointed at the artifact's own
    directory (its rows as the study would return them)."""
    a = artifacts.ARTIFACTS[study]
    out_dir = _artifact_dir(study)
    rows = artifacts.read_rows(out_dir / a.csv)
    meta = None
    if study == "richardson":
        meta = json.loads((out_dir / "Mesh Convergence Analysis"
                           / "study_metadata.json").read_text())
    worst = run_studies._check(study, out_dir, rows, meta)
    assert max(worst[c] for c in a.rel) == 0.0
    assert ("profiles" in worst) == (study == "no_uptake")
    assert ("convergence" in worst) == (study == "richardson")


def test_run_studies_writes_under_the_base(tmp_path):
    proc = _run(["fenics_eff_uptake_tpu_torch.run_studies", "phase_a_mu",
                 "--device", "cpu", "--mesh-size", "0.1", "--out-base",
                 str(tmp_path)])
    assert proc.returncode == 0, proc.stderr
    csv_path = (tmp_path / "phase_a_cpu_h0.1"
                / artifacts.ARTIFACTS["phase_a_mu"].csv)
    rows = artifacts.read_rows(csv_path)
    assert len(rows) == 20
    assert all(np.isfinite(float(r["Mu_Eff_Simulation"])) for r in rows)
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    assert summary["phase_a_mu"]["rows"] == 20
    assert json.loads((tmp_path / "run_studies.json").read_text()) \
        == summary
    assert not (ROOT / "examples" / "phase_a_cpu_h0.1").exists()


def test_run_studies_refuses():
    """--check holds rows only at h = 0.02; without a card the default
    device fails the run."""
    with pytest.raises(ValueError, match="0.02"):
        run_studies.run(["phase_a_mu"], "cpu", 0.1, check=True)
    proc = _run(["fenics_eff_uptake_tpu_torch.run_studies", "phase_a_mu",
                 "--mesh-size", "0.1", "--out-base", "build/never"])
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr

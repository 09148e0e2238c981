"""The port's line profiles and the no-uptake study's profile CSVs against
the JAX package's.

``compute_conc_profiles`` and ``collect_profile_rows`` run on one
concentration (a smooth field on the JAX mesh at h = 0.15, carried into the
port by ``convert``) on a sulcus and a rectangular mesh, to 1e-12; both
CSV exports are written by each package from the same profile runs and
held cell for cell (numbers to 1e-12, text equal).  The study itself
writes ``Profiles/`` for its profile geometries with the committed
artifact's file names and headers; against the JAX study at h = 0.15 in
``test_profile_csvs_of_the_study_match_jax`` (slow: two Stokes solves on
the JAX side).
"""

import csv
from pathlib import Path

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu.analysis import profiles as jprof
from fenics_eff_uptake_tpu.fem.space import Function as JFunction
from fenics_eff_uptake_tpu.fem.space import FunctionSpace as JSpace
from fenics_eff_uptake_tpu.meshing.generator import generate_mesh as jgen
from fenics_eff_uptake_tpu.studies import no_uptake as jnu
from fenics_eff_uptake_tpu_torch import convert
from fenics_eff_uptake_tpu_torch.analysis import profiles as tprof
from fenics_eff_uptake_tpu_torch.fem.space import Function as TFunction
from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace as TSpace
from fenics_eff_uptake_tpu_torch.studies import no_uptake as tnu

torch.set_num_threads(2)

GOLDEN = (Path(__file__).resolve().parents[1] / "examples"
          / "no_uptake_tpu_h0.02" / "Geometry Comparison Analysis"
          / "Profiles")
H = 0.15


def _read(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def _params(pe, domain_type):
    if domain_type == "rectangular":
        return tnu._make_params(pe, mesh_size_dim=H)
    return tnu._make_params(pe, 1.0, 1.0, H)


def _field(domain_type, pe):
    """(JAX c, port c, params) of one smooth concentration on the JAX mesh
    of the profile geometry ``largest`` (or the rectangle)."""
    p = _params(pe, domain_type)
    g = p.get_mesh_generator_params()
    jm = jgen(domain_type=domain_type, **g)
    jsp = JSpace(jm, "P2")
    xy = np.asarray(jsp.dof_coords)
    vals = (np.exp(-0.3 * pe * xy[:, 0]) * (1.0 + 0.2 * xy[:, 1])
            + 0.05 * np.sin(3.0 * xy[:, 0] * xy[:, 1]))
    tsp = TSpace(convert.mesh_from(jm), "P2")
    return (JFunction(jsp, vals), TFunction(tsp, vals.copy()), p, jm,
            tsp.mesh)


@pytest.fixture(scope="module", params=["sulcus", "rectangular"])
def fields(request):
    return request.param, [_field(request.param, pe) for pe in (0.1, 10.0)]


def _close(a, b, path=""):
    """Nested dicts, lists and tuples equal in structure and keys, numbers
    within 1e-12 (relative above 1)."""
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, (float, np.floating)):
        assert abs(a - b) <= 1e-12 * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_compute_conc_profiles_matches_jax(fields):
    domain_type, runs = fields
    for jc, tc, p, jm, tm in runs:
        got = tprof.compute_conc_profiles(tc, tm, p, domain_type)
        want = jprof.compute_conc_profiles(jc, jm, p, domain_type)
        _close(got, want)
        lines = got["profiles_full"]["horizontal"]
        assert ("sulcus_mid" in lines) == (domain_type == "sulcus")
        assert len(got["profiles"]["vertical"]) == 3


def test_extract_line_profile_drops_points_outside():
    _, tc, p, _, tm = _field("sulcus", 1.0)
    xs, vs = tprof.extract_line_profile(tc, "x", -0.5, (0.0, p.L), 200)
    assert 0 < len(xs) < 200 and len(xs) == len(vs)
    assert xs.min() >= tm.vertices[:, 0].min() - 1e-12
    assert np.all(np.isfinite(vs))


def _runs(fields, package):
    domain_type, runs = fields
    out = []
    for jc, tc, p, jm, tm in runs:
        if package == "port":
            rows = tnu.collect_profile_rows(tc, tm, p, "largest", "largest",
                                            domain_type=domain_type)
        else:
            rows = jnu.collect_profile_rows(jc, jm, p, "largest", "largest",
                                            domain_type=domain_type)
        out.append({"geometry": "largest", "rows": rows})
    return out


def test_collect_profile_rows_matches_jax(fields):
    got, want = _runs(fields, "port"), _runs(fields, "jax")
    assert len(got[0]["rows"]) > 1000
    _close([r["rows"] for r in got], [r["rows"] for r in want])


def _hold_csv(got_path, want_path):
    got, want = _read(got_path), _read(want_path)
    assert list(got[0]) == list(want[0])
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            try:
                a, b = float(g[k]), float(w[k])
            except ValueError:
                assert g[k] == w[k], (i, k)
                continue
            assert abs(a - b) <= 1e-12 * max(1.0, abs(b)), (i, k, a, b)
    return got


def test_profile_csv_exports_match_jax(fields, tmp_path):
    """Both exports, each package's writer on each package's rows of the
    same runs (and the rectangle's overlay appended, as the study does)."""
    got, want = _runs(fields, "port"), _runs(fields, "jax")
    overlay = [r for run in got for r in run["rows"]][:50]
    got.append({"geometry": "largest", "rows": overlay})
    want.append({"geometry": "largest", "rows": overlay})
    tnu.export_profile_samples_csv_sulci(got, str(tmp_path / "port"))
    tnu.export_profile_stats_csv(got, str(tmp_path / "port"))
    jnu.export_profile_samples_csv_sulci(want, str(tmp_path / "jax"))
    jnu.export_profile_stats_csv(want, str(tmp_path / "jax"))
    samples = _hold_csv(tmp_path / "port" / "profiles_samples_largest.csv",
                        tmp_path / "jax" / "profiles_samples_largest.csv")
    stats = _hold_csv(tmp_path / "port" / "profiles_largest.csv",
                      tmp_path / "jax" / "profiles_largest.csv")
    assert list(samples[0]) == list(_read(
        GOLDEN / "profiles_samples_largest.csv")[0])
    assert list(stats[0]) == list(_read(GOLDEN / "profiles_largest.csv")[0])
    # per run, its lines sorted by (line type, name, Pe)
    first = [(r["line_type"], r["name"]) for r in stats
             if r["Peclet"] == stats[0]["Peclet"]][:3]
    assert first == sorted(first)


@pytest.fixture(scope="module")
def port_study(tmp_path_factory):
    base = tmp_path_factory.mktemp("nu_prof")
    rows, stats = tnu.run_geometry_study(["square_small"], [0.1, 1.0], H,
                                         base_dir=str(base), device="cpu",
                                         verbose=False)
    return base / "Geometry Comparison Analysis" / "Profiles", rows, stats


def test_study_writes_the_profile_csvs(port_study):
    prof, rows, stats = port_study
    assert sorted(p.name for p in prof.iterdir()) == [
        "Grids", "profiles_samples_square_small.csv",
        "profiles_square_small.csv"]
    # the profile grid of the samples, as the JAX study draws it
    assert sorted(p.name for p in (prof / "Grids").iterdir()) == [
        "profiles_grid_square_small.pdf", "profiles_grid_square_small.png"]
    samples = _read(prof / "profiles_samples_square_small.csv")
    golden = _read(GOLDEN / "profiles_samples_square_small.csv")
    assert list(samples[0]) == list(golden[0])
    # the sulcus's rows of each Pe, then the rectangle's overlay
    doms = [r["Domain"] for r in samples]
    assert doms[0] == "sulcus" and doms[-1] == "rectangular"
    assert doms == sorted(doms, key=lambda d: d != "sulcus")
    assert {r["Peclet"] for r in samples} == {"0.1", "1.0"}
    assert all(np.isfinite(float(r["c"])) for r in samples)
    st = _read(prof / "profiles_square_small.csv")
    assert list(st[0]) == list(_read(GOLDEN / "profiles_square_small.csv")[0])
    assert sum(int(r["n_samples"]) for r in st) == len(samples)
    assert len(rows) == 4 and all(s["profiles_s"] >= 0 for s in stats)


def test_study_without_profile_geometries_writes_none(tmp_path):
    tnu.run_geometry_study(["reference"], [1.0], H, base_dir=str(tmp_path),
                           device="cpu", verbose=False)
    assert not (tmp_path / "Geometry Comparison Analysis"
                / "Profiles").exists()


@pytest.mark.slow
def test_profile_csvs_of_the_study_match_jax(port_study, tmp_path):
    prof, _, _ = port_study
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FEU_DISK_CACHE", "0")
        from fenics_eff_uptake_tpu.plotting import no_uptake_plots
        mp.setattr(no_uptake_plots, "generate_all_plots",
                   lambda *a, **k: None)
        mp.setattr(no_uptake_plots, "plot_profiles_grid_from_samples_csv",
                   lambda *a, **k: None)
        jnu.run_geometry_study([0.1, 1.0], H, geometries=["square_small"],
                               base_dir=str(tmp_path), verbose=False)
    jprof_dir = tmp_path / "Geometry Comparison Analysis" / "Profiles"
    for name in ("profiles_samples_square_small.csv",
                 "profiles_square_small.csv"):
        got, want = _read(prof / name), _read(jprof_dir / name)
        assert list(got[0]) == list(want[0]) and len(got) == len(want)
        for g, w in zip(got, want):
            for k in w:
                try:
                    a, b = float(g[k]), float(w[k])
                except ValueError:
                    assert g[k] == w[k], k
                    continue
                # the two studies' solves: the transport tolerance of
                # tests/test_torch_no_uptake.py
                assert abs(a - b) <= 1e-8 * max(1.0, abs(b)), (k, a, b)

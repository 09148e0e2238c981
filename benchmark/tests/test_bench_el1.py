"""The graded cell and the geometry-flow cell: their readers on synthetic
runs (nothing where what they read is absent, as on a program without
the counters), and their manifest entries, configuration and mixes."""

import sys
import types

import pytest

from benchmark.harness import Run, _reader
from benchmark.manifest import Cell, load_manifest
from benchmark.traffic import Traffic, load_mix

PROGRAM = "fenics_eff_uptake_tpu_torch.utils.profiling"
CELLS = ("advdiff.geometry_flow", "el1.rung8")


def synthetic(windows=True):
    reqs = [
        {"id": 0, "seconds": 5.0, "points": 3, "traced": True,
         "iters": [40, 60, 180], "stages": {"meshing": 0.4, "stokes": 2.6,
                                            "assembly": 0.5, "solve": 0.6}},
        {"id": 1, "seconds": 4.0, "points": 3, "traced": False,
         "iters": [40, 60, 170], "stages": {"meshing": 0.3, "stokes": 2.4,
                                            "assembly": 0.4, "solve": 0.5}},
        {"id": 2, "seconds": 4.0, "points": 3, "traced": False,
         "iters": [41, 61, 172], "stages": {"meshing": 0.3, "stokes": 2.2,
                                            "assembly": 0.4, "solve": 0.5}},
    ]
    win = [{"wall": 4.0, "busy": 0.8, "device": 0.9, "ops": {},
            "stages": {"solve": {"wall": 0.6, "busy": 0.4, "device": 0.5,
                                 "ops": {}}},
            "solve_bound_s": 0.01}]
    return Run(reqs, win if windows else [])


def counters(**kw):
    return types.SimpleNamespace(**kw)


@pytest.mark.parametrize("name,program,value", [
    ("stokes_s_per_req", None, 2.3),
    ("minres_iters_per_stokes",
     counters(stokes_solves=4, minres_steps=1000), 250.0),
    ("transfer_band_fill",
     counters(rect_band_entries=30, rect_band_slots=1200), 0.025),
    ("graded_solve_roofline", None, 100 * 0.01 / 0.5)])
def test_reader(monkeypatch, name, program, value):
    if program is not None:
        monkeypatch.setitem(sys.modules, PROGRAM, program)
    assert _reader(name)(synthetic()) == pytest.approx(value)


@pytest.mark.parametrize("name,program", [
    # a mix on one geometry: Stokes in set-up only
    ("stokes_s_per_req", None),
    # the program absent, without the counters (the parent), or at zero
    ("minres_iters_per_stokes", "absent"),
    ("minres_iters_per_stokes", counters(host_syncs=3)),
    ("minres_iters_per_stokes", counters(stokes_solves=0, minres_steps=0)),
    ("transfer_band_fill", "absent"),
    ("transfer_band_fill", counters(krylov_steps=3)),
    ("transfer_band_fill", counters(rect_band_entries=0, rect_band_slots=0)),
    ("graded_solve_roofline", None)])
def test_reader_finds_nothing(monkeypatch, name, program):
    if program == "absent":
        monkeypatch.delitem(sys.modules, PROGRAM, raising=False)
    elif program is not None:
        monkeypatch.setitem(sys.modules, PROGRAM, program)
    run = synthetic(windows=False)
    for q in run.requests:
        q["stages"].pop("stokes")
    assert _reader(name)(run) is None


@pytest.mark.parametrize("cell", CELLS)
def test_cells_load_with_their_metrics(cell):
    c = Cell(cell)
    assert c.chips == 1
    assert c.config["mode"] == "adv-diff"
    names = {m["name"] for m in c.per_layer}
    new = {"advdiff.geometry_flow": {"stokes_s_per_req",
                                     "minres_iters_per_stokes"},
           "el1.rung8": {"transfer_band_fill", "graded_solve_roofline"}}
    assert new[cell] <= names
    assert not (set().union(*new.values()) - new[cell]) & names
    r = Traffic(c.mix).next()
    assert r["Pe"] == [0.1, 1.0, 10.0] and r["mu_factor"] == [0.0] * 3


def test_graded_configuration_is_the_flow_one_at_factor_8():
    flow = Cell("advdiff.flow_sweep").config
    graded = Cell("el1.rung8").config
    keys = ("mode", "element", "L_dim", "H_dim", "mesh_size_dim", "D_dim",
            "mu_dim_base", "rtol", "solver_options", "stokes_options")
    assert {k: graded[k] for k in keys} == {k: flow[k] for k in keys}
    assert graded["refinement_factor"] == 8
    man = load_manifest()
    (entry,) = [c for c in man["configs"] if c["name"] == graded["name"]]
    assert entry["source"] == graded["source"]
    assert Traffic(load_mix("el1_rung8")).next()["geometry"] == (
        "deep_large", 0.4, 2.0)


def test_geometry_flow_is_the_geometry_sweeps_order():
    want = [tuple(g) for g in load_mix("geometry_sweep")["geometries"]]
    t = Traffic(load_mix("geometry_flow"))
    got = [t.next()["geometry"] for _ in range(2 * len(want))]
    assert got == [(n, float(w), float(d)) for n, w, d in want] * 2

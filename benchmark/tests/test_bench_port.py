"""The system under test follows its configuration file: the studies'
option dicts reach the port's entries, a mode it does not drive raises,
and the flow is remade when the geometry changes and only then."""

import contextlib
import copy

import pytest

from benchmark import port as port_module
from benchmark.manifest import Cell
from benchmark.port import Port


class Reached(Exception):
    pass


def stage(name):
    return contextlib.nullcontext()


def config(workload, **changes):
    cfg = copy.deepcopy(Cell(workload).config)
    cfg["mesh_size_dim"] = 0.07
    cfg.update(changes)
    return cfg


def test_solver_options_reach_the_hierarchy_and_the_solve():
    opts = {"coarse_inverse": "marker", "cycle": "mult", "n_smooth": 2,
            "inner_rtol": 1e-6}
    p = Port(config("noadv.mu_sweep", solver_options=opts, rtol=1e-11),
             "cpu")
    seen = {}

    def build(*a, **kw):
        seen["build"] = kw
        return "hierarchy"

    def solve(*a, **kw):
        seen["solve"] = kw
        raise Reached

    p.build_multilevel_for, p.solve_sweep = build, solve
    req = {"id": 0, "geometry": ("g", 0.25, 0.25), "mu_factor": [1.0, 2.0]}
    with pytest.raises(Reached):
        p.request(req, stage)
    assert seen["build"] == {"coarse_inverse": "marker"}
    assert seen["solve"] == {"mu_values": seen["solve"]["mu_values"],
                             "rtol": 1e-11, "multilevel": "hierarchy",
                             "cycle": "mult", "n_smooth": 2,
                             "inner_rtol": 1e-6}


def test_control_takes_the_f32_solve():
    p = Port(config("noadv.mu_sweep", solver_options={"cycle": "add"}),
             "cpu", control=True)
    assert p.solve_options == {"cycle": "add", "precision": "f32"}


@pytest.mark.parametrize("change", [
    {"mode": "no-uptake"}, {"element": "P1"}, {"mu_dim_base": 0.001},
    {"solver_options": {"no_such_option": 1}},
    {"stokes_options": {"rtol": 1e-9}}])
def test_what_the_drivers_would_not_honour_raises(change):
    with pytest.raises(ValueError):
        Port(config("noadv.mu_sweep", **change), "cpu")


def test_flow_follows_the_geometry(monkeypatch):
    calls = []

    def mesh(p, kind):
        calls.append(("mesh", p.sulci_w_dim, p.sulci_h_dim))
        return object()

    def stokes(mesh, H, device, **kw):
        calls.append(("stokes", kw))
        return object(), object()

    monkeypatch.setattr(port_module, "make_mesh", mesh)
    monkeypatch.setattr(port_module, "stokes_for_study", stokes)
    p = Port(config("advdiff.flow_sweep",
                    stokes_options={"rtol": 1e-8}), "cpu")
    p.setup(("ref", 0.5, 1.0), stage)
    p._flow_for(("ref", 0.5, 1.0), stage)
    assert calls == [("mesh", 0.5, 1.0), ("stokes", {"rtol": 1e-8})]
    p._flow_for(("other", 0.3, 0.6), stage)
    p._flow_for(("other", 0.3, 0.6), stage)
    assert calls[2:] == [("mesh", 0.3, 0.6), ("stokes", {"rtol": 1e-8})]

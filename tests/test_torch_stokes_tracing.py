"""The Stokes solve's spans and counters and the transfer plans' counters
(``utils/profiling.py``).

* Off (the default), a Stokes solve records no span and never enters a
  ``record_function``, even while a profiler runs; its counters still
  move.
* On, ``stokes_for_study`` gives one ``stokes`` span holding
  ``stokes.setup`` (the velocity hierarchy and saddle operators, with
  their assembly and level spans), one ``stokes.pass`` per MINRES pass and
  the ``stokes.certify`` defect residuals, one after another.
* ``minres_steps`` moves by the solve's ``outer_iters``, ``stokes_solves``
  by one and ``stokes_host_syncs`` by the hand count of its host reads;
  ``host_syncs`` and ``krylov_steps`` (the transport solves') do not move.
* A transfer plan past the width menu (w0.4/d2.0 refined 16 times at
  h = 0.05) counts in ``rect_band_widened``; the uniform h = 0.07 mesh's
  plans do not; every plan counts its live entries and band slots.
"""

import math
from collections import Counter

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu_torch.models import stokes_flow
from fenics_eff_uptake_tpu_torch.studies import common
from fenics_eff_uptake_tpu_torch.utils import profiling
from fenics_eff_uptake_tpu_torch.utils.diskcache import clear_memos
from fenics_eff_uptake_tpu_torch.utils.profiling import recording, take

torch.set_num_threads(2)

H = 0.07
KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
COUNTERS = ("host_syncs", "krylov_steps", "stokes_solves", "minres_steps",
            "stokes_host_syncs")
PLAN_COUNTERS = ("rect_band_plans", "rect_band_widened",
                 "rect_band_entries", "rect_band_slots")


def _read(names):
    return {k: getattr(profiling, k) for k in names}


def _delta(before, names):
    return {k: getattr(profiling, k) - v for k, v in before.items()
            if k in names}


@pytest.fixture(autouse=True)
def _cold(monkeypatch):
    """Every solve builds what it uses: no disk entry, no memo."""
    monkeypatch.setenv("FEU_DISK_CACHE", "0")
    clear_memos()
    take()
    yield
    clear_memos()
    take()


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(mesh_size=H, **KW)


def _path(s, by_id):
    names = [s.name]
    while s.parent:
        s = by_id[s.parent]
        names.append(s.name)
    return "/".join(reversed(names))


def test_off_records_nothing_and_enters_no_record_function(mesh,
                                                            monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    before = _read(COUNTERS)
    u, _ = common.stokes_for_study(mesh, 1.0, "cpu")
    assert take() == []
    d = _delta(before, COUNTERS)
    assert d["stokes_solves"] == 1
    assert d["minres_steps"] == u.solver_info["outer_iters"] > 0


def test_on_gives_the_stokes_span_tree(mesh):
    with recording():
        u, _ = common.stokes_for_study(mesh, 1.0, "cpu")
    spans = take()
    info = u.solver_info
    assert info["converged"] and info["passes"] >= 1
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    (top,) = [s for s in spans if not s.parent]
    assert top.name == "stokes"
    kids = sorted((s for s in spans if s.parent == top.id),
                  key=lambda s: s.start_ns)
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    names = [s.name for s in kids]
    # the set-up, then the defect residual before each pass and the one
    # that finds the field converged
    assert names == ["stokes.setup"] + ["stokes.certify", "stokes.pass"] \
        * info["passes"] + ["stokes.certify"]
    paths = Counter(_path(s, by_id) for s in spans)
    assert paths["stokes/stokes.setup/assembly"] == 1
    assert paths["stokes/stokes.setup/ml_setup.level_systems"] == 1
    assert paths["stokes/stokes.setup/ml_setup.transfers"] == 1
    assert not any(p.startswith("solve") or p.startswith("ml_setup")
                   for p in paths)


@pytest.mark.parametrize("precision", ["mixed", "f64"])
def test_counters_equal_the_hand_count(mesh, monkeypatch, precision):
    calls = []
    plain = stokes_flow.minres_tree

    def counted(*a, **kw):
        res = plain(*a, **kw)
        calls.append(res.iters)
        return res

    monkeypatch.setattr(stokes_flow, "minres_tree", counted)
    before = _read(COUNTERS)
    u, _ = stokes_flow.stokes_solve_mg(mesh, 1.0, "cpu",
                                       precision=precision)
    d = _delta(before, COUNTERS)
    info = u.solver_info
    assert info["converged"]
    assert d["host_syncs"] == 0 and d["krylov_steps"] == 0
    assert d["stokes_solves"] == 1
    assert d["minres_steps"] == info["outer_iters"] == sum(calls)
    assert len(calls) == info["passes"]
    certify = info["passes"] + 1 if precision == "mixed" else 1
    # S_Z of the set-up; |b|; each defect residual; per MINRES call its
    # opening |z|, one |eta| per chunk of CHUNK steps and the count; the
    # field's two copies
    per_call = sum(2 + math.ceil(it / stokes_flow.CHUNK) for it in calls)
    assert d["stokes_host_syncs"] == 1 + 1 + certify + per_call + 2


def _graded(h, factor):
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import _make_params
    p = _make_params(0.1, 0.4, 2.0, h)
    p.refinement_factor = factor
    return generate_mesh(domain_type="sulcus",
                         **p.get_mesh_generator_params())


@pytest.mark.parametrize("h,factor,widened", [(H, 1, False),
                                              (0.05, 16, True)])
def test_transfer_plans_count_widened_windows(h, factor, widened):
    from fenics_eff_uptake_tpu_torch.parallel.sweep import \
        build_transport_system
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel, level_meshes_for)
    mesh = _graded(h, factor)
    sys_ = build_transport_system(mesh, "cpu")
    before = _read(PLAN_COUNTERS)
    ml = build_multilevel(sys_, level_meshes_for(mesh), np.ones(2),
                          np.zeros(2))
    d = _delta(before, PLAN_COUNTERS)
    # a prolongation and a restriction plan per level
    assert d["rect_band_plans"] == 2 * len(ml.levels)
    assert (d["rect_band_widened"] > 0) is widened
    # the live entries are those of the transfers' nonzero weights, twice
    live = sum(int(np.count_nonzero(np.asarray(la.transfer.weights)))
               for la in ml.levels)
    assert d["rect_band_entries"] == 2 * live
    slots = sum(b.numel() for la in ml.levels
                for b in (la.bands.p, la.bands.r))
    assert d["rect_band_slots"] == slots

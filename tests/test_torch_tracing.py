"""The port's span recorder and solve counters (``utils/profiling.py``).

* Off (the default), a study sweep records no span and never enters a
  ``record_function``, even while a profiler runs.
* On, the sweep gives the span tree of its layers: ``meshing``,
  ``assembly``, ``ml_setup``, ``solve``, ``metrics`` with their children,
  each child inside its parent, the ``ml_setup`` children one after
  another.
* ``host_syncs`` and ``krylov_steps`` move by the hand count of each
  solve path's host reads and loop trips.
* A span's interval, put on a profile's record timeline, encloses the
  records opened inside it (on the card: a kernel launched and synced
  inside it).  The card's test is marked ``cuda``; this file imports no
  JAX, so ``--noconftest`` runs it there.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.fem.space import Function, FunctionSpace
from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw
from fenics_eff_uptake_tpu_torch.studies import common
from fenics_eff_uptake_tpu_torch.utils import profiling
from fenics_eff_uptake_tpu_torch.utils.diskcache import clear_memos
from fenics_eff_uptake_tpu_torch.utils.profiling import (
    device_trace, on_timeline, recording, span, take)
from fenics_eff_uptake_tpu_torch.utils.timers import StageTimer

torch.set_num_threads(2)

H = 0.07                       # below the multigrid threshold
FACTORS = [0.1, 1.0, 10.0]
KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
D, MU = [10.0, 1.0, 0.5], [0.1, 1.0, 3.0]
ML_CHILDREN = ("ml_setup.level_meshes", "ml_setup.level_velocities",
               "ml_setup.level_systems", "ml_setup.transfers",
               "ml_setup.transfer_bands", "ml_setup.coarse_inverse")


@pytest.fixture(autouse=True)
def _cold(monkeypatch):
    """Every sweep builds what it uses: no disk entry, no memo."""
    monkeypatch.setenv("FEU_DISK_CACHE", "0")
    clear_memos()
    take()
    yield
    clear_memos()
    take()


def _velocity(V):
    xy = np.asarray(V.dof_coords)
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * xy[:, 1] * (1.0 - xy[:, 1])
    u[1::2] = 0.3 * np.sin(xy[:, 0]) * np.clip(-xy[:, 1], 0.0, None)
    return u


def _no_adv_sweep():
    geom = common.make_no_adv_params(1.0, sulci_w_dim=0.25,
                                     sulci_h_dim=0.25, mesh_size_dim=H)
    common.no_adv_batch(geom, FACTORS, "sulcus", "cpu", verbose=False)


def _adv_sweep():
    mesh = generate_mesh(mesh_size=H, **KW)
    V = FunctionSpace(mesh, "P2", vs=2)
    u = Function(V, _velocity(V))
    common.transport_batch(mesh, u, [10.0, 1.0], [0.5, 5.0], "cpu")


SWEEPS = {"no_adv": _no_adv_sweep, "adv": _adv_sweep}


def _path(s, by_id):
    names = [s.name]
    while s.parent:
        s = by_id[s.parent]
        names.append(s.name)
    return "/".join(reversed(names))


# ---------------------------------------------------------------------------
# off and on
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_enters_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _no_adv_sweep()
    assert take() == []
    # the patch bites once recording is on
    with recording(), pytest.raises(AssertionError, match="entered"):
        with span("probe"):
            pass


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_on_gives_the_layer_span_tree(sweep):
    with recording():
        SWEEPS[sweep]()
    spans = take()
    assert spans
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    paths = Counter(_path(s, by_id) for s in spans)
    top = {s.name for s in spans if not s.parent}
    # transport_batch leaves the metrics to its caller
    assert top == {"meshing", "assembly", "ml_setup", "solve"} | (
        {"metrics"} if sweep == "no_adv" else set())
    for child in ("assembly.space", "assembly.elements", "assembly.reorder",
                  "assembly.bands"):
        assert paths[f"assembly/{child}"] >= 1, child
        assert paths[f"ml_setup/ml_setup.level_systems/assembly/{child}"] \
            >= 1, child
    if sweep == "no_adv":
        for child in ("meshing.seeds", "meshing.triangulate",
                      "meshing.mesh_data"):
            assert paths[f"meshing/{child}"] >= 1, child
    # the ml_setup children: each once, in order, none overlapping
    (ml,) = [s for s in spans if s.name == "ml_setup"]
    kids = sorted((s for s in spans if s.parent == ml.id),
                  key=lambda s: s.start_ns)
    names = [s.name for s in kids]
    expect = [n for n in ML_CHILDREN
              if sweep == "adv" or n != "ml_setup.level_velocities"]
    assert names == expect
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    # the solve: the preconditioner, the defect passes, the certification
    (solve,) = [s for s in spans if s.name == "solve"]
    sk = Counter(s.name for s in spans if s.parent == solve.id)
    assert sk["solve.preconditioner"] == 1
    assert sk["solve.pass"] >= 2
    assert sk["solve.certify"] >= 1
    assert set(sk) == {"solve.preconditioner", "solve.pass",
                       "solve.certify"}
    assert paths["metrics"] == (2 if sweep == "no_adv" else 0)


def test_take_clears_and_recording_restores():
    with recording():
        with span("a"):
            with span("b"):
                pass
        with recording():
            pass
        with span("c"):
            pass
    with span("off"):
        pass
    got = take()
    assert [s.name for s in got] == ["b", "a", "c"]
    a, b = got[1], got[0]
    assert b.parent == a.id and a.parent == 0 and got[2].parent == 0
    assert take() == []


def test_stage_timer_stage_is_a_span():
    timer = StageTimer()
    with recording():
        with timer.stage("mesh"):
            with span("inner"):
                pass
        with timer.stage("mesh"):
            pass
    spans = take()
    assert [s.name for s in spans] == ["inner", "mesh", "mesh"]
    assert spans[0].parent == spans[1].id
    assert set(timer.times) == {"mesh"} and timer.counts == {"mesh": 2}


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """Systems at h = 0.07, pure diffusion and advection, with their
    hierarchies."""
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import \
        build_multilevel_for
    mesh = generate_mesh(mesh_size=H, **KW)
    V = FunctionSpace(mesh, "P2", vs=2)
    u = Function(V, _velocity(V))
    out = {}
    for name, kw in (("cg", {}), ("bicgstab", dict(u_values=u.values,
                                                   u_space=u.space))):
        sys_ = tsw.build_transport_system(mesh, "cpu", **kw)
        ml = build_multilevel_for(sys_, mesh, D, MU,
                                  u_fine=u if kw else None)
        out[name] = (sys_, ml)
    return out


# (system, precision): the host reads of a solve beside its loop trips
# (steps: iterations run; passes: P), and the operator applies by dtype
# that count the steps independently of the counter
CASES = {
    # bnorm; a leading pass test; per pass the steps and one failing
    # loop test; the cheap-pass test; the closing loop's P - 1 tests;
    # rn and iters
    ("cg", "mixed"): dict(syncs=lambda st, P: 1 + 1 + st + P + 1 + (P - 1)
                          + 2,
                          steps=lambda f32, f64: f32),
    # bnorm; per pass the steps, one failing loop test and one pass test;
    # rn and iters
    ("bicgstab", "mixed"): dict(syncs=lambda st, P: 1 + st + 2 * P + 2,
                                steps=lambda f32, f64: f32 // 2),
    # bnorm; the steps and one failing loop test; iters, resnorm and
    # converged of the result; the true residual
    ("cg", "f64"): dict(syncs=lambda st, P: 1 + st + 1 + 3 + 1,
                        steps=lambda f32, f64: f64 - 2),
    ("bicgstab", "f64"): dict(syncs=lambda st, P: 1 + st + 1 + 3 + 1,
                              steps=lambda f32, f64: (f64 - 2) // 2),
}


@pytest.mark.parametrize("system,precision", sorted(CASES),
                         ids=lambda v: str(v))
def test_counters_equal_the_hand_count(small, monkeypatch, system,
                                       precision):
    applies = Counter()
    plain = tsw.apply_operator

    def counted(a, X):
        applies[a.D_vec.dtype] += 1
        return plain(a, X)

    monkeypatch.setattr(tsw, "apply_operator", counted)
    s0, k0 = profiling.host_syncs, profiling.krylov_steps
    sys_, ml = small[system]
    X, info = tsw.solve_sweep(sys_, D, mu_values=MU, rtol=1e-10,
                              multilevel=ml, precision=precision)
    syncs = profiling.host_syncs - s0
    steps = profiling.krylov_steps - k0
    assert info["converged"].all()
    case = CASES[(system, precision)]
    assert steps == case["steps"](applies[torch.float32],
                                  applies[torch.float64])
    assert steps >= int(np.max(info["iters"]))
    P = info.get("passes", 1)
    if precision == "mixed":
        assert P >= 2
    assert syncs == case["syncs"](steps, P)


# ---------------------------------------------------------------------------
# the clock
# ---------------------------------------------------------------------------

def test_span_encloses_a_record_opened_inside_it(tmp_path):
    with device_trace(str(tmp_path)) as prof:
        with span("outer"):
            with torch.profiler.record_function("inner"):
                torch.ones(64).sum()
    (outer,) = on_timeline(take(), prof)
    events = {e.name: e for e in prof.events()
              if e.name in ("outer", "inner")}
    assert set(events) == {"outer", "inner"}
    for e in events.values():       # its own label and the inner one
        assert outer[3] <= e.time_range.start
        assert e.time_range.end <= outer[4]
    assert list(tmp_path.glob("trace_*.json"))


@pytest.mark.cuda
@pytest.mark.parametrize("activities", ["cuda", "cpu+cuda"])
def test_span_encloses_its_kernels_on_the_card(activities):
    """A span around kernels, each launched and synced inside it, encloses
    their device records on the record timeline.  The profiler on that
    machine drops records now and then (a whole short trace at times), so
    up to five traces are taken and at least one must keep a record."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + (
        [ProfilerActivity.CPU] if activities == "cpu+cuda" else [])
    x = torch.ones(1 << 16, device="cuda")
    torch.cuda.synchronize()
    kept = 0
    for _ in range(5):
        with profile(activities=acts) as prof, recording():
            with span("kernels"):
                for _ in range(8):
                    torch.cuda._sleep(100_000)
                    x.mul_(1.0)
                    torch.cuda.synchronize()
        (s,) = on_timeline(take(), prof)
        recs = [e for e in prof.events()
                if str(e.device_type).endswith("CUDA")]
        for e in recs:
            assert s[3] <= e.time_range.start, (s, e.name, e.time_range)
            assert e.time_range.end <= s[4], (s, e.name, e.time_range)
        kept += len(recs)
        if kept:
            break
    assert kept

"""The mixed solve's Krylov step replayed as a CUDA graph
(``solvers.batched.KrylovGraph``, ``parallel.sweep._inner_loop``).

On the CPU, each a case over CG and BiCGStab:

* a mixed solve on CPU tensors takes the eager ``krylov_loop`` once per
  pass, and ``krylov_graph_captures`` / ``krylov_graph_steps`` do not
  move;
* ``LaunchCounts`` on a stand-in counter set (integers and a tally that
  the stand-in A and M move): a capture of one step leaves the counters
  as they were and keeps what they moved by; each replay adds that once,
  so k replays count what k eager steps count;
* ``KrylovGraph.loop`` over a graph stand-in (its capture runs the body
  and leaves the buffers as they were, its replay runs the body and moves
  no counter), loop after loop on one graph, equals ``krylov_loop`` bit
  for bit: state, iterations, host syncs, steps and the counters; one
  capture, every step after the first replayed;
* the same stand-in through the mixed solve on a small multigrid system,
  with few inner iterations a pass so that it runs many passes: X,
  iterations, passes and residual norms bit for bit.

On the card (marker ``cuda``, ``--noconftest``), the same system on CUDA
tensors, graphed against eager (``_inner_loop`` swapped for the eager
loop), at the default and at few inner iterations a pass: X, iterations,
passes and residual norms bit for bit; one capture per solve; the kernel
launch counters and the launches by band as the eager solve's; a profiled
graphed solve is whole (``benchmark.tracer.is_whole``); and the memory
allocated and reserved return to their levels before the solve.
"""

import functools
import gc
from collections import Counter
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw
from fenics_eff_uptake_tpu_torch.solvers import batched
from fenics_eff_uptake_tpu_torch.solvers.batched import (
    KrylovGraph, LaunchCounts, _colnorm, bicgstab_state, bicgstab_step,
    cg_state, cg_step, krylov_loop)
from fenics_eff_uptake_tpu_torch.utils import profiling

torch.set_num_threads(2)

METHODS = {"cg": (cg_step, cg_state), "bicgstab": (bicgstab_step,
                                                    bicgstab_state)}
# A and M calls of one step
CALLS = {"cg": 1, "bicgstab": 2}
D, MU = [1.0, 0.1, 10.0], [0.0, 1.0, 0.5]
N_DENSE, B = 40, 3


def _counters():
    return (profiling.host_syncs, profiling.krylov_steps,
            profiling.krylov_graph_captures, profiling.krylov_graph_steps)


def _delta(c0):
    return tuple(b - a for a, b in zip(c0, _counters()))


# ---------------------------------------------------------------------------
# stand-ins
# ---------------------------------------------------------------------------

def _stand_in_counts():
    """(owner, tally, LaunchCounts over them): A adds to ``a`` and to the
    tally's "A", M to ``m`` and "M"."""
    owner = SimpleNamespace(a=0, m=0)
    tally = Counter()
    return owner, tally, LaunchCounts([(owner, "a"), (owner, "m")], [tally])


def _dense(method, owner, tally, seed=3):
    """(A, M, rhs) of a seeded dense system whose A and M move the stand-in
    counters."""
    g = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(g.standard_normal((N_DENSE, N_DENSE)))
    lam = np.logspace(0.0, 1.5, N_DENSE)
    if method == "cg":
        A = (Q * lam) @ Q.T
        A = 0.5 * (A + A.T)
    else:
        A = (np.diag(2.0 + lam / 5.0)
             + g.standard_normal((N_DENSE, N_DENSE)) / N_DENSE ** 0.5)
    A = torch.tensor(A)
    dinv = 1.0 / torch.diagonal(A)

    def op(X):
        owner.a += 1
        tally["A"] += 1
        return A @ X

    def M(R):
        owner.m += 1
        tally["M"] += 1
        return dinv[:, None] * R

    return op, M, torch.tensor(g.standard_normal((N_DENSE, B)))


class _StandInGraph:
    """A CUDA graph's behaviour on the CPU: the capture runs the body's
    host side and leaves its buffers as they were; a replay runs the
    captured work, which moves no host counter."""

    def __init__(self, body, device):
        self.g = g = body.__self__
        bufs = [*g._state, g._tol, g._active, g._cit, g._flag]
        keep = [t.clone() for t in bufs]
        body()
        for t, k in zip(bufs, keep):
            t.copy_(k)

    def replay(self):
        c = self.g._counts
        with LaunchCounts(c.attrs, c.tallies).capture():
            self.g._body()


@pytest.fixture
def stand_in_graph(monkeypatch):
    monkeypatch.setattr(batched, "_cuda_graph", _StandInGraph)


# ---------------------------------------------------------------------------
# the counter bookkeeping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", sorted(METHODS))
def test_launch_counts_roll_back_at_capture_and_add_per_replay(method):
    step, start = METHODS[method]
    owner, tally, counts = _stand_in_counts()
    op, M, rhs = _dense(method, owner, tally)
    state = start(M, torch.zeros_like(rhs), rhs)
    active = torch.ones(B, dtype=torch.bool)
    owner.a = owner.m = 5
    tally.clear()
    tally.update({"A": 5, "M": 5, "other": 2})
    with counts.capture():
        step(op, M, state, active)
        assert (owner.a, owner.m) == (5 + CALLS[method], 5 + CALLS[method])
    assert (owner.a, owner.m) == (5, 5)
    assert tally == Counter({"A": 5, "M": 5, "other": 2})
    k = 4
    for _ in range(k):
        counts.replayed()
    eager_owner, eager_tally, _ = _stand_in_counts()
    op_e, M_e, _ = _dense(method, eager_owner, eager_tally)
    for _ in range(k):
        state = step(op_e, M_e, state, active)
    assert owner.a - 5 == eager_owner.a == k * CALLS[method]
    assert owner.m - 5 == eager_owner.m == k * CALLS[method]
    assert tally - Counter({"A": 5, "M": 5, "other": 2}) == eager_tally


@pytest.mark.parametrize("method", sorted(METHODS))
def test_graph_loop_equals_the_eager_loop(method, stand_in_graph,
                                          monkeypatch):
    step, start = METHODS[method]
    owner, tally, counts = _stand_in_counts()
    op, M, rhs = _dense(method, owner, tally)
    monkeypatch.setattr(batched, "_kernel_counts", lambda: counts)
    graph = KrylovGraph(step, op, M)
    tol = 1e-9 * _colnorm(rhs)
    # loops of one solve: a capped first loop (the eager step, the capture
    # and replays up to the cap), one capped at a single step, a converged
    # start, a loop to convergence, and one with a column converged
    starts = [(rhs, 5), (0.5 * rhs, 1), (torch.zeros_like(rhs), 8),
              (rhs.flip(1), 10_000), (rhs * torch.tensor([1.0, 0.0, 1.0]),
                                      10_000)]
    c0, steps_total = _counters(), 0
    for R, maxiter in starts:
        s0 = start(M, torch.zeros_like(R), R)
        e0, a0, m0, t0 = _counters(), owner.a, owner.m, Counter(tally)
        want, want_it = krylov_loop(step, op, M, s0, tol, maxiter)
        eager = (_delta(e0), owner.a - a0, owner.m - m0, tally - t0)
        g0, a0, m0, t0 = _counters(), owner.a, owner.m, Counter(tally)
        got, got_it = graph.loop(s0, tol, maxiter)
        graphed = (_delta(g0), owner.a - a0, owner.m - m0, tally - t0)
        for name, a, b in zip(want._fields, want, got):
            assert torch.equal(a, b), name
        assert torch.equal(want_it, got_it)
        # syncs and steps as the eager loop's; the launches of its steps
        assert eager[0][:2] == graphed[0][:2]
        assert eager[1:] == graphed[1:]
        steps_total += graphed[0][1]
    assert steps_total > 12
    d = _delta(c0)
    assert d[2] == 1                              # one capture
    assert d[3] == steps_total - 1                # all but the eager step


# ---------------------------------------------------------------------------
# the mixed solves on a small multigrid system
# ---------------------------------------------------------------------------

def _system(method, device):
    from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace
    from fenics_eff_uptake_tpu_torch.meshing.generator import generate_mesh
    from fenics_eff_uptake_tpu_torch.solvers.multilevel import (
        build_multilevel, level_meshes_for)
    mesh = generate_mesh(width=10.0, height=1.0, sulcus_depth=1.0,
                         sulcus_width=0.5, mesh_size=0.15,
                         refinement_factor=1, domain_type="sulcus")
    kw = {}
    if method == "bicgstab":
        V = FunctionSpace(mesh, "P2", vs=2)
        u = np.zeros(V.ndofs)
        u[0::2] = 4.0 * V.dof_coords[:, 1] * (1.0 - V.dof_coords[:, 1])
        kw = dict(u_values=u, u_space=V)
    sys = tsw.build_transport_system(mesh, device, **kw)
    return sys, build_multilevel(sys, level_meshes_for(mesh), D, MU)


@pytest.fixture(scope="module")
def cpu_systems():
    return {m: _system(m, "cpu") for m in METHODS}


def _eager_inner_loop(step, a32, M, RHS):
    return functools.partial(krylov_loop, step,
                             lambda P: tsw.apply_operator(a32, P), M)


def _graphed_inner_loop(step, a32, M, RHS):
    return KrylovGraph(step, lambda P: tsw.apply_operator(a32, P), M).loop


def _solve(sys, ml, maxiter):
    X, info = tsw.solve_sweep(sys, D, MU, multilevel=ml, maxiter=maxiter)
    return X, info


def _same(a, b):
    (Xa, ia), (Xb, ib) = a, b
    assert torch.equal(Xa, Xb)
    for k in ("iters", "resnorm", "passes", "converged"):
        assert np.array_equal(ia[k], ib[k]), k


@pytest.mark.parametrize("method", sorted(METHODS))
def test_cpu_solves_take_the_eager_loop(method, cpu_systems, monkeypatch):
    sys, ml = cpu_systems[method]
    calls = []

    def counted(*args, **kw):
        calls.append(args[-1])
        return krylov_loop(*args, **kw)

    monkeypatch.setattr(tsw, "krylov_loop", counted)
    c0 = _counters()
    X, info = _solve(sys, ml, 50_000)
    d = _delta(c0)
    assert info["converged"].all()
    assert len(calls) == info["passes"] and set(calls) == {tsw.N_INNER}
    assert d[2:] == (0, 0) and d[1] >= 10
    monkeypatch.setattr(tsw, "_inner_loop", _eager_inner_loop)
    _same((X, info), _solve(sys, ml, 50_000))


@pytest.mark.parametrize("method", sorted(METHODS))
def test_graph_stand_in_solve_equals_the_eager_solve(method, cpu_systems,
                                                     stand_in_graph,
                                                     monkeypatch):
    sys, ml = cpu_systems[method]
    monkeypatch.setattr(tsw, "_inner_loop", _eager_inner_loop)
    c0 = _counters()
    eager = _solve(sys, ml, 4)
    de = _delta(c0)
    monkeypatch.setattr(tsw, "_inner_loop", _graphed_inner_loop)
    c0 = _counters()
    graphed = _solve(sys, ml, 4)
    dg = _delta(c0)
    _same(eager, graphed)
    assert graphed[1]["passes"] >= 4
    assert dg[:2] == de[:2] and dg[2] == 1 and dg[3] == dg[1] - 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_systems():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return {m: _system(m, "cuda") for m in METHODS}


def _launches():
    from fenics_eff_uptake_tpu_torch.ops.banded import launches_by_band
    from fenics_eff_uptake_tpu_torch.parallel.sharding import \
        kernel_launches
    return kernel_launches(), Counter(launches_by_band)


def _launch_delta(l0):
    (k0, b0), (k1, b1) = l0, _launches()
    return {k: k1[k] - k0[k] for k in k1}, b1 - b0


@pytest.mark.cuda
@pytest.mark.parametrize("maxiter", [50_000, 4])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_cuda_graphed_solve_equals_the_eager_solve(method, maxiter,
                                                   cuda_systems,
                                                   monkeypatch):
    sys, ml = cuda_systems[method]
    _solve(sys, ml, maxiter)                     # binds, builds, warms
    c0, l0 = _counters(), _launches()
    graphed = _solve(sys, ml, maxiter)
    dg, lg = _delta(c0), _launch_delta(l0)
    monkeypatch.setattr(tsw, "_inner_loop", _eager_inner_loop)
    c0, l0 = _counters(), _launches()
    eager = _solve(sys, ml, maxiter)
    de, le = _delta(c0), _launch_delta(l0)
    _same(eager, graphed)
    if maxiter == 4:
        assert graphed[1]["passes"] >= 4
    assert dg[:2] == de[:2] and de[2:] == (0, 0)
    assert dg[2] == 1 and dg[3] == dg[1] - 1
    assert lg == le and le[0]["band_apply"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(METHODS))
def test_cuda_profiled_graphed_solve_is_whole(method, cuda_systems):
    from torch.profiler import ProfilerActivity, profile

    from benchmark.tracer import HAND_KERNELS, is_whole
    sys, ml = cuda_systems[method]
    _solve(sys, ml, 50_000)
    torch.cuda.synchronize()
    c0, l0 = _counters(), _launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _solve(sys, ml, 50_000)
        torch.cuda.synchronize()
    assert _delta(c0)[3] > 0
    k = _launch_delta(l0)[0]
    launched = k["band_apply"] + k["rect_band_apply"] + k["element_apply"]
    names = [e.name for e in prof.events()
             if str(e.device_type).endswith("CUDA")]
    hand = sum(any(h in n for h in HAND_KERNELS) for n in names)
    assert is_whole(names, launched), (hand, launched)


@pytest.mark.cuda
@pytest.mark.parametrize("method", sorted(METHODS))
def test_cuda_graph_memory_is_freed_with_the_solve(method, cuda_systems):
    # the multigrid cycle's closures are a cycle (vcycle calls itself) that
    # holds its cast D, mu and omega (1.5 KB) until the collector runs,
    # with or without a graph: collect before each reading
    sys, ml = cuda_systems[method]
    _solve(sys, ml, 50_000)
    torch.cuda.synchronize()
    gc.collect()
    before = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    c0 = _counters()
    out = _solve(sys, ml, 50_000)
    torch.cuda.synchronize()
    assert _delta(c0)[2] == 1
    del out
    gc.collect()
    # the capture reuses the pool of the one before: nothing more reserved
    assert (torch.cuda.memory_allocated(),
            torch.cuda.memory_reserved()) == before

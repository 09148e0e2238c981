"""The port's sharded execution (``parallel/sharding.py``,
``parallel/sharded_solve.py``) against the JAX package's sharded functions.

Four gloo ranks on the CPU (``RankGroup(4, tp=2, device="cpu")``: 2 sweep
rows x 2 cells ranks; tp = 4 for Stokes), started once for the module; the
JAX reference runs in this process on ``make_device_mesh(4, tp=2)`` of the
8 virtual CPU devices that ``tests/conftest.py`` provides, on the same
meshes and coefficients.  The ranks import no JAX: checked in a rank
through ``sys.modules``.  Each test mirrors one of
``tests/test_parallel.py``'s sharded tests and holds the port also against
its own unsharded f64 solve:

  round-1 sweep (:33)          atol 1e-7
  MG-CG (:71)                  1e-9 absolute, CG iterations equal to JAX's
  Jacobi BiCGStab (:104)       1e-8
  Stokes MINRES (:146)         u, p 1e-7 relative; MINRES iterations
                               within queue 3's spread of JAX's (4, stated)
  step-mu Robin (:181)         1e-8 relative to scale
  step-mu Robin with MG (:234) 1e-8 relative to scale; JAX's test builds
                               no hierarchy at h = 0.15 (its threshold is
                               0.08), so both packages build one here on
                               level_meshes_for's meshes, and the BiCGStab
                               runs under the V-cycle

and the partition: all-reduces per iteration (1 / 3 / 2 / 6 / 3: Jacobi
CG, MG-CG, Jacobi BiCGStab, BiCGStab under the cycle, Stokes MINRES), each
rank's fine chunk of ceil(N / tp) elements, and nccl with more ranks than
cards refused.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fenics_eff_uptake_tpu.fem.space import FunctionSpace as JSpace
from fenics_eff_uptake_tpu.meshing.generator import (generate_mesh,
                                                     structured_rectangle)
from fenics_eff_uptake_tpu.parallel import sharded_solve as jss
from fenics_eff_uptake_tpu.parallel import sharding as jsh
from fenics_eff_uptake_tpu.parallel import sweep as jsw
from fenics_eff_uptake_tpu.params import StepUptakeOpen as JStep
from fenics_eff_uptake_tpu_torch.convert import mesh_from
from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw
from fenics_eff_uptake_tpu_torch.parallel.sharded_solve import (
    solve_sweep_sharded, stokes_solve_sharded)
from fenics_eff_uptake_tpu_torch.parallel.sharding import (
    RankGroup, loaded_modules, resolve_backend, solve_mu_sweep_sharded)
from fenics_eff_uptake_tpu_torch.params import StepUptakeOpen
from fenics_eff_uptake_tpu_torch.solvers import multilevel as tml

torch.set_num_threads(2)

SULCUS = dict(width=5.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
              refinement_factor=1, domain_type="sulcus")
RECT = dict(width=5.0, height=1.0, sulcus_depth=0.0, sulcus_width=0.0,
            refinement_factor=1, domain_type="rectangular")
MUS = np.array([0.1, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0])
STEPS = [(0.1, 1.7), (1.0, 0.6), (10.0, 3.0), (0.5, 0.5)]
D_STEP = np.array([10.0, 1.0, 0.1, 1.0])


@pytest.fixture(scope="module")
def group():
    g = RankGroup(4, tp=2, device="cpu")
    yield g
    g.close()


def _poiseuille(space):
    xy = space.dof_coords
    u = np.zeros(space.ndofs)
    u[0::2] = 4.0 * xy[:, 1] * (1.0 - xy[:, 1])
    return u


def _step(cls, mb, mt):
    return cls(mu_base=mb, mu_eff_target=mt, sulcus_left_x=2.25,
               sulcus_right_x=2.75, L_c=0.05, Gamma=5.0)


def _rel_to_scale(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _per_rank(group, key):
    return [r[1][key] for r in group.results]


@pytest.mark.slow
def test_round1_sweep_matches_jax(group):
    """``ShardedMuSweep`` (Jacobi CG, K + mu R, cells split, 5 mu padded to
    6 over dp = 2) against JAX's on the 10 x 5 structured rectangle."""
    jmesh = structured_rectangle(2.0, 1.0, 10, 5)
    mus = [0.1, 0.5, 1.0, 2.0, 5.0]
    Xj = np.asarray(jsh.build_sharded_mu_sweep(
        jmesh, jsh.make_device_mesh(4, tp=2), D=1.0, rtol=1e-12,
        maxiter=5000).solve(mus))
    X = solve_mu_sweep_sharded(group, mesh_from(jmesh), mus, rtol=1e-12,
                               maxiter=5000)
    assert X.shape == (5, Xj.shape[1])
    assert np.abs(X - Xj).max() < 1e-7
    # the port's own unsharded f64 sweep of the same problem
    sys = tsw.build_transport_system(mesh_from(jmesh), "cpu")
    Xu, _ = tsw.solve_sweep(sys, np.ones(5), mus, rtol=1e-13,
                            precision="f64")
    assert np.abs(X - Xu.numpy()).max() < 1e-7


def _sulcus_mg(D, mus):
    """The JAX and port fine systems of the 5 x 1 sulcus at h = 0.15 and
    their hierarchies on the mids at 0.3 and 0.6."""
    from fenics_eff_uptake_tpu.solvers.multilevel import build_multilevel
    jm = generate_mesh(mesh_size=0.15, **SULCUS)
    jmids = [generate_mesh(mesh_size=h, **SULCUS) for h in (0.3, 0.6)]
    jsys = jsw.build_transport_system(jm, element="P2", pad_shapes=False)
    jml = build_multilevel(jsys, jmids, D, mu_values=mus)
    sys = tsw.build_transport_system(mesh_from(jm), "cpu")
    ml = tml.build_multilevel(sys, [mesh_from(m) for m in jmids], D, mus)
    return jsys, jml, sys, ml


def test_sharded_mg_cg_matches_jax(group):
    """Chunked MG-CG under the partition (the main path's solve) against
    JAX's ``sharded_solve_sweep``: X within 1e-9, the same CG iterations,
    3 all-reduces per iteration, each rank's chunk ceil(N / 2), the call
    recorded in the group's ``log``; the ranks hold no module of JAX or of
    the JAX package after the solve."""
    D = np.ones_like(MUS)
    jsys, jml, sys, ml = _sulcus_mg(D, MUS)
    Xj, ij = jss.sharded_solve_sweep(
        jss.build_sharded_system(jsys, jsh.make_device_mesh(4, tp=2),
                                 multilevel=jml),
        D, MUS, rtol=1e-11, chunk_iters=20, maxiter=2000)
    group.log = []
    X, info = solve_sweep_sharded(group, sys, D, MUS, multilevel=ml,
                                  rtol=1e-11, chunk_iters=20, maxiter=2000)
    (rec,), group.log = group.log, None
    assert rec["kind"] == "sweep" and rec["X"] is X and rec["info"] is info
    assert rec["multilevel"] is ml and info["parent_device_bytes"] == 0
    assert (info["rel_resnorm"] < 1e-10).all() and info["converged"].all()
    assert (info["true_rel_resnorm"] < 1e-10).all()
    assert np.abs(X.numpy() - np.asarray(Xj)).max() < 1e-9
    np.testing.assert_array_equal(info["iters"], np.asarray(ij["iters"]))
    assert info["all_reduces_per_iter"] == 3
    N = sys.K.A64.shape[0]
    assert _per_rank(group, "elements") == [-(-N // 2)] * 4
    Xu, _ = tsw.solve_sweep(sys, D, MUS, rtol=1e-12, multilevel=ml,
                            precision="f64")
    assert np.abs(X.numpy() - Xu.numpy()).max() < 1e-9
    mods = group.run(loaded_modules)
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib")
           or m == "fenics_eff_uptake_tpu"
           or m.startswith("fenics_eff_uptake_tpu.")]
    assert not bad, bad
    assert "fenics_eff_uptake_tpu_torch.parallel.sharded_solve" in mods


@pytest.mark.slow
def test_sharded_jacobi_bicgstab_matches_jax(group):
    """The nonsymmetric sweep (Poiseuille advection, D = 0.25, Jacobi)
    under the partition against JAX's: 1e-8, 2 all-reduces per
    iteration; and in f32 against the f64 solve."""
    jm = generate_mesh(mesh_size=0.15, **SULCUS)
    u = _poiseuille(JSpace(jm, "P2", vs=2))
    jsys = jsw.build_transport_system(jm, element="P2", pad_shapes=False,
                                      u_values=jnp.asarray(u),
                                      u_space=JSpace(jm, "P2", vs=2))
    D = np.full_like(MUS, 0.25)
    Xj, _ = jss.sharded_solve_sweep(
        jss.build_sharded_system(jsys, jsh.make_device_mesh(4, tp=2)),
        D, MUS, rtol=1e-11, chunk_iters=40, maxiter=4000)
    m = mesh_from(jm)
    sys = tsw.build_transport_system(m, "cpu", u_values=u,
                                     u_space=FunctionSpace(m, "P2", vs=2))
    X, info = solve_sweep_sharded(group, sys, D, MUS, rtol=1e-11,
                                  chunk_iters=40, maxiter=4000)
    assert (info["rel_resnorm"] < 1e-10).all() and info["converged"].all()
    assert np.abs(X.numpy() - np.asarray(Xj)).max() < 1e-8
    assert info["all_reduces_per_iter"] == 2
    Xu, _ = tsw.solve_sweep(sys, D, MUS, rtol=1e-12, precision="f64")
    assert np.abs(X.numpy() - Xu.numpy()).max() < 1e-8
    # f32=True: the Krylov state and every apply in f32 (the f32 kernel
    # forms on the card), certified by an f64 residual
    X32, i32 = solve_sweep_sharded(group, sys, D, MUS, rtol=1e-6,
                                   chunk_iters=40, maxiter=4000, f32=True)
    assert i32["converged"].all() and (i32["true_rel_resnorm"] < 1e-5).all()
    assert _rel_to_scale(X32.numpy(), Xu.numpy()) < 1e-4


@pytest.mark.slow
def test_sharded_stokes_matches_jax(tmp_path, monkeypatch):
    """Saddle MINRES under the partition (4 cells ranks: velocity K and the
    divergence split, one fused all-reduce per saddle apply) against
    JAX's: u, p within 1e-7 relative, MINRES iterations within 4 of JAX's
    (queue 3: the nonsymmetric counts are held within JAX's own spread),
    3 all-reduces per iteration; and against the port's f64
    ``stokes_solve_mg``."""
    from fenics_eff_uptake_tpu_torch.models.stokes_flow import \
        stokes_solve_mg
    jm = generate_mesh(mesh_size=0.15, **SULCUS)
    uj, pj, ij = jss.sharded_stokes_solve(
        jss.build_sharded_stokes(jm, H=1.0,
                                 device_mesh=jsh.make_device_mesh(4, tp=4)),
        rtol=1e-10, chunk_iters=40)
    monkeypatch.setenv("FEU_CACHE_DIR", str(tmp_path))   # a cold solve
    with RankGroup(4, tp=4, device="cpu") as g4:
        u, p = stokes_solve_sharded(g4, mesh_from(jm), 1.0, rtol=1e-10,
                                    chunk_iters=40)
        elements = [r["elements"] for r in u.solver_info["ranks"]]
    info = u.solver_info
    assert info["converged"] and info["rel_resnorm"] < 1e-8
    assert info["method"] == "minres+mg+sharded"
    assert info["all_reduces_per_iter"] == 3
    assert len(set(elements)) == 1
    for a, b in ((u.values, uj.values), (p.values, pj.values)):
        assert _rel_to_scale(a, b) < 1e-7
    # 111 against JAX's 112 on the CPU
    assert abs(info["outer_iters"] - ij["outer_iters"]) <= 4, (
        info["outer_iters"], ij["outer_iters"])
    u0, p0 = stokes_solve_mg(mesh_from(jm), 1.0, "cpu", rtol=1e-10,
                             precision="f64")
    assert _rel_to_scale(u.values, u0.values) < 1e-7
    assert _rel_to_scale(p.values, p0.values) < 1e-7


def _rect_step_systems():
    jm = generate_mesh(mesh_size=0.15, **RECT)
    JV = JSpace(jm, "P2", vs=2)
    u = _poiseuille(JV)
    jsys = jsw.build_transport_system(jm, element="P2", pad_shapes=False,
                                      u_values=jnp.asarray(u), u_space=JV)
    jsteps = [_step(JStep, *s) for s in STEPS]
    jR = np.stack([np.asarray(jsw.robin_matrices_for_mu(jsys, s))
                   for s in jsteps])
    m = mesh_from(jm)
    V = FunctionSpace(m, "P2", vs=2)
    sys = tsw.build_transport_system(m, "cpu", u_values=u, u_space=V)
    steps = [_step(StepUptakeOpen, *s) for s in STEPS]
    R = torch.stack([tsw.robin_matrices_for_mu(sys, s) for s in steps])
    return jm, JV, u, jsys, jsteps, jR, m, V, sys, steps, R


@pytest.mark.slow
def test_sharded_step_mu_robin_matches_jax(group):
    """Per-sample step-mu Robin matrices split over "cells" and "sweep"
    (Jacobi BiCGStab) against JAX's: 1e-8 relative to scale."""
    *_, jsys, jsteps, jR, m, V, sys, steps, R = _rect_step_systems()
    Xj, _ = jss.sharded_solve_sweep(
        jss.build_sharded_system(jsys, jsh.make_device_mesh(4, tp=2),
                                 robin_batch=jR),
        D_STEP, np.zeros_like(D_STEP), rtol=1e-11, chunk_iters=40,
        maxiter=4000)
    X, info = solve_sweep_sharded(group, sys, D_STEP, robin_matrices=R,
                                  rtol=1e-11, chunk_iters=40, maxiter=4000)
    assert (info["rel_resnorm"] < 1e-10).all()
    assert _rel_to_scale(X.numpy(), Xj) < 1e-8
    Xu, _ = tsw.solve_sweep(sys, D_STEP, robin_matrices=R, rtol=1e-12,
                            precision="f64")
    assert _rel_to_scale(X.numpy(), Xu.numpy()) < 1e-8


def test_sharded_step_mu_robin_with_mg_matches_jax(group):
    """Per-sample Robin under the V-cycle: the fine batch rides the sharded
    operator, the mid levels' batches the replicated cycle (level meshes
    of ``level_meshes_for``, built in both packages: JAX's
    ``build_multilevel_for`` with its threshold raised).  Against JAX's
    sharded solve: 1e-8 relative to scale; 6 all-reduces per BiCGStab
    iteration; against the port's unsharded f64 solve."""
    from fenics_eff_uptake_tpu.fem.space import Function as JFunction
    from fenics_eff_uptake_tpu.solvers.multilevel import \
        build_multilevel_for as j_ml_for
    jm, JV, u, jsys, jsteps, jR, m, V, sys, steps, R = _rect_step_systems()
    jml = j_ml_for(jsys, jm, D_STEP, mu_callables=jsteps,
                   robin_matrices_fine=jnp.asarray(jR),
                   u_fine=JFunction(JV, jnp.asarray(u)), h_threshold=1.0)
    Xj, _ = jss.sharded_solve_sweep(
        jss.build_sharded_system(jsys, jsh.make_device_mesh(4, tp=2),
                                 multilevel=jml, robin_batch=jR),
        D_STEP, np.zeros_like(D_STEP), rtol=1e-11, chunk_iters=20,
        maxiter=4000)
    from fenics_eff_uptake_tpu_torch.fem.space import Function
    meshes = tml.level_meshes_for(m)
    ml = tml.build_multilevel(
        sys, meshes, D_STEP,
        u_levels=tml.level_velocities(Function(V, u), meshes),
        robin_matrices_levels=tml.level_robin_matrices(meshes, steps),
        robin_matrices_fine=R)
    X, info = solve_sweep_sharded(group, sys, D_STEP, multilevel=ml,
                                  robin_matrices=R, rtol=1e-11,
                                  chunk_iters=20, maxiter=4000)
    assert (info["rel_resnorm"] < 1e-10).all() and info["converged"].all()
    assert info["all_reduces_per_iter"] == 6
    assert _rel_to_scale(X.numpy(), Xj) < 1e-8
    Xu, _ = tsw.solve_sweep(sys, D_STEP, robin_matrices=R, multilevel=ml,
                            rtol=1e-12, precision="f64")
    assert _rel_to_scale(X.numpy(), Xu.numpy()) < 1e-8


def test_nccl_with_more_ranks_than_cards_raises():
    """NCCL takes one card per rank: 4 ranks on this host's cards (none
    here, one on the H100's machine) are refused before any rank starts,
    with a message that names gloo; gloo is the CPU default."""
    with pytest.raises(ValueError, match="backend='gloo'"):
        RankGroup(4, tp=2, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend='gloo'"):
        resolve_backend("cuda", "nccl", torch.cuda.device_count() + 1)
    assert resolve_backend("cpu", None, 4) == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            RankGroup(2, tp=1, device="cuda")

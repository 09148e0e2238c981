"""The port's advective (nonsymmetric) sweep against the JAX package.

Both packages run the configuration the JAX package runs on a TPU:
banded K and Adv on the fine system, a 4-level hierarchy (P2 -> P1 on the
same mesh -> P1 at 0.3 -> P1 at 0.45, passed explicitly) whose levels carry
the velocity interpolated onto them, windowed-band transfers, banded level
applies, the multiplicative V(1,1) cycle, and up to 12 f64 passes of f32
BiCGStab.  JAX is forced into it with the environment tests/test_banded.py
uses (its default cycle for BiCGStab is already "mult").  The velocity is
a seeded analytic P2 field with both components nonzero.

Tolerances:
* operator on JAX-carried arrays: 1e-12 relative in f64, 2e-5 in f32 (the
  band's summation order, as tests/test_banded.py);
* solutions, on two meshes: 1e-9 absolute on true dofs; passes equal;
  per-column BiCGStab iterations within the spread JAX shows between its
  own banded and element forms of the same fine operator, measured in the
  test (f32 BiCGStab counts move with the summation order alone: 63 and 67
  on the Pe = 10 column at h = 0.15);
* coarsest inverses: bit for bit, given JAX's coarse row count (its
  compile-key padding, which the port does not copy, enters the mean of the
  1e-6 diagonal shift);
* one mult cycle on the JAX hierarchy's own arrays: 1e-5 relative (f32
  chains of band, transfer and element applies);
* advective metrics given the same X: 1e-10 relative (same f64 formulas).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fenics_eff_uptake_tpu.analysis.profiles import eval_function
from fenics_eff_uptake_tpu.fem.space import Function, FunctionSpace
from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu.parallel import sweep as jsw
from fenics_eff_uptake_tpu.solvers import multilevel as jml
from fenics_eff_uptake_tpu.studies.no_uptake import \
    _make_params as j_make_params
from fenics_eff_uptake_tpu_torch.convert import (mesh_from,
                                                 multilevel_from_arrays,
                                                 transport_system_from_arrays,
                                                 velocity_from_values)
from fenics_eff_uptake_tpu_torch.ops.banded import band_apply
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw
from fenics_eff_uptake_tpu_torch.solvers import multilevel as tml

torch.set_num_threads(2)

KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
TPU_ENV = {"FEU_ML_TBAND": "1", "FEU_ML_BAND": "1"}
PES = np.array([0.1, 1.0, 10.0])
RTOL = 1e-12


def _velocity(mesh):
    V = FunctionSpace(mesh, "P2", vs=2)
    xy = V.dof_coords
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * xy[:, 1] * (1.0 - xy[:, 1])
    u[1::2] = 0.3 * np.sin(xy[:, 0]) * np.clip(-xy[:, 1], 0.0, None)
    return u, V


def _jax_level_velocities(u, V, levels):
    """The JAX ``build_multilevel_for`` interpolation, for explicit
    levels."""
    out = []
    for m in levels:
        if m is V.mesh:
            out.append((jnp.asarray(u), V))
            continue
        Vl = FunctionSpace(m, "P2", vs=2)
        vals, ok = eval_function(Function(V, jnp.asarray(u)), Vl.dof_coords)
        vals = np.where(ok[:, None], vals, 0.0)
        inter = np.zeros(Vl.ndofs)
        inter[0::2] = vals[:, 0]
        inter[1::2] = vals[:, 1]
        out.append((jnp.asarray(inter), Vl))
    return out


def _meshes(mesh_size):
    mesh = generate_mesh(mesh_size=mesh_size, **KW)
    return mesh, [mesh] + [generate_mesh(mesh_size=m, **KW)
                           for m in (0.3, 0.45)]


def _jax_sweep(mesh, levels, u, V, band):
    """JAX's sweep in its TPU configuration; ``band`` False swaps the fine
    banded operator for its element form.  Returns (system, hierarchy, X,
    info, f32 preconditioner)."""
    D = 1.0 / PES
    mus = np.zeros(3)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TPU_ENV.items():
            mp.setenv(k, v)
        mp.delenv("FEU_ML_CYCLE", raising=False)
        jsys = jsw.build_transport_system(mesh, u_values=jnp.asarray(u),
                                          u_space=V, pad_shapes=True,
                                          band=band)
        jm = jml.build_multilevel(jsys, levels, D, mu_values=mus,
                                  u_levels=_jax_level_velocities(u, V,
                                                                 levels))
        Xj, ij = jsw.solve_sweep(jsys, D, mu_values=mus, rtol=RTOL,
                                 precision="mixed", multilevel=jm)
        M = jml.make_ml_preconditioner(jm, f32=True)
    return jsys, jm, np.asarray(Xj), ij, M


def _port_sweep(mesh, levels, u):
    """The port's sweep on the same meshes, carried over by
    ``convert.mesh_from``; returns its level meshes too."""
    tmesh = mesh_from(mesh)
    tlevels = [tmesh] + [mesh_from(m) for m in levels[1:]]
    uf = velocity_from_values(u, tmesh)
    D = 1.0 / PES
    mus = np.zeros(3)
    psys = tsw.build_transport_system(tmesh, "cpu", u_values=uf.values,
                                      u_space=uf.space)
    pml = tml.build_multilevel(psys, tlevels, D, mus,
                               u_levels=tml.level_velocities(uf, tlevels))
    Xp, ip = tsw.solve_sweep(psys, D, mus, rtol=RTOL, multilevel=pml)
    return uf, psys, pml, Xp.numpy(), ip, tlevels


@pytest.fixture(scope="module")
def run():
    mesh, levels = _meshes(0.15)
    u, V = _velocity(mesh)
    jsys, jm, Xj, ij, M = _jax_sweep(mesh, levels, u, V, band=True)
    ij_elem = _jax_sweep(mesh, levels, u, V, band=False)[3]
    uf, psys, pml, Xp, ip, tlevels = _port_sweep(mesh, levels, u)
    return SimpleNamespace(mesh=mesh, levels=levels, tlevels=tlevels,
                           u=uf, D=1.0 / PES,
                           mus=np.zeros(3), jsys=jsys, jml=jm, Xj=Xj, ij=ij,
                           ij_elem=ij_elem, M=M, psys=psys, pml=pml, Xp=Xp,
                           ip=ip)


@pytest.fixture(scope="module")
def run_fine():
    """The sweeps alone on a second, finer mesh."""
    mesh, levels = _meshes(0.12)
    u, V = _velocity(mesh)
    _, _, Xj, ij, _ = _jax_sweep(mesh, levels, u, V, band=True)
    ij_elem = _jax_sweep(mesh, levels, u, V, band=False)[3]
    Xp, ip = _port_sweep(mesh, levels, u)[3:5]
    return SimpleNamespace(Xj=Xj, ij=ij, ij_elem=ij_elem, Xp=Xp, ip=ip)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_advective_operator_matches_jax(run, f32):
    carried = transport_system_from_arrays(
        jsw._system_to_arrays(run.jsys), run.mesh, "P2", "cpu")
    assert carried.Adv is not None and carried.Advband is not None
    dt = np.float32 if f32 else np.float64
    X = np.random.default_rng(0).standard_normal(
        (run.jsys.ndofs, 3)).astype(dt)
    A_fn = jsw._operator_program(jsw.sys_struct_key(run.jsys))[0]
    a = jsw.operator_args(run.jsys, jnp.asarray(run.D),
                          jnp.asarray(run.mus), None, f32=f32)
    ref = np.asarray(A_fn(a, jnp.asarray(X)))
    got = tsw.apply_operator(tsw.operator_args(carried, run.D, run.mus,
                                               f32=f32),
                             torch.as_tensor(X)).numpy()
    assert got.dtype == dt
    assert _rel(got, ref) < (2e-5 if f32 else 1e-12)
    dref = np.asarray(jml._fine_dinv(run.jsys, jnp.asarray(run.D),
                                     jnp.asarray(run.mus), None))
    assert _rel(tsw.fine_dinv(carried, run.D, run.mus).numpy(), dref) < 1e-6


def test_advective_system_matches_jax(run):
    """Same dof order, and the port's own Adv block and band apply JAX's
    operator on true dofs."""
    n = run.psys.space.ndofs
    np.testing.assert_array_equal(run.psys.perm[:n], run.jsys.perm[:n])
    N = run.psys.Adv.A64.shape[0]
    assert _rel(run.psys.Adv.A64.numpy(),
                np.asarray(run.jsys.Adv.A64)[:N]) < 1e-12
    X = np.zeros((run.jsys.ndofs, 3), np.float32)
    X[:n] = np.random.default_rng(1).standard_normal((n, 3))
    Yj = band_apply(torch.tensor(np.asarray(run.jsys.Advband)),
                    torch.as_tensor(X)).numpy()
    Yp = band_apply(run.psys.Advband,
                    torch.as_tensor(X[:run.psys.ndofs])).numpy()
    assert _rel(Yp[:n], Yj[:n]) < 1e-5


@pytest.mark.parametrize("case", ["run", "run_fine"],
                         ids=["h0.15", "h0.12"])
def test_bicgstab_sweep_matches_jax(request, case):
    r = request.getfixturevalue(case)
    assert r.Xp.shape == r.Xj.shape
    assert float(np.abs(r.Xp - r.Xj).max()) < 1e-9
    assert r.ip["passes"] == r.ij["passes"] == r.ij_elem["passes"]
    it_p = np.asarray(r.ip["iters"])
    it_j = np.asarray(r.ij["iters"])
    spread = int(np.abs(np.asarray(r.ij_elem["iters"]) - it_j).max())
    assert (np.abs(it_p - it_j) <= spread).all(), (it_p, it_j, spread)
    assert (r.ip["rel_resnorm"] <= RTOL).all()


def test_advective_hierarchy_matches_jax(run):
    """Same level orderings; level inverse diagonals including Adv (f32,
    1e-6); level Adv blocks from the interpolated velocity (1e-12)."""
    for pl, jl in zip(run.pml.levels, run.jml.levels):
        n = pl.sys.space.ndofs
        np.testing.assert_array_equal(pl.sys.perm[:n],
                                      np.asarray(jl.sys.perm)[:n])
        assert _rel(pl.dinv.numpy()[:n], np.asarray(jl.dinv)[:n]) < 1e-6
        N = pl.sys.Adv.A64.shape[0]
        assert _rel(pl.sys.Adv.A64.numpy(),
                    np.asarray(jl.sys.Adv.A64)[:N]) < 1e-12


def test_advective_coarse_inverse_matches_jax(run):
    """The coarsest inverses (symmetrised constrained Adv, 1e-6
    mean-|diagonal| shift, f32 inverse) equal JAX's bit for bit once the
    port's coarsest system carries JAX's padding rows; with the port's own
    (fewer) padding rows only the shift moves, which shows in the
    advection-dominated Pe = 10 column alone."""
    uv, us = tml.level_velocities(run.u, run.tlevels)[-1]
    csys = tsw.build_transport_system(run.tlevels[-1], "cpu", element="P1",
                                      u_values=uv, u_space=us)
    jA = np.asarray(run.jml.Ainv)
    nj = jA.shape[1]
    assert nj > csys.ndofs
    padded = csys._replace(ndofs=nj, free=torch.cat(
        [csys.free, torch.zeros(nj - csys.ndofs, dtype=torch.bool)]))
    np.testing.assert_array_equal(tml._coarse_inverses(padded, run.D,
                                                       run.mus)[0], jA)
    own = run.pml.Ainv.numpy()
    n = own.shape[1]
    assert _rel(own[:2], jA[:2, :n, :n]) < 2e-5
    assert _rel(own[2], jA[2, :n, :n]) < 1e-3


def test_mult_cycle_on_carried_state_matches_jax(run):
    """One multiplicative V(1,1) cycle of the port on the JAX advective
    hierarchy's own arrays equals JAX's cycle."""
    jm = run.jml
    meshes = run.levels
    lv = []
    for i, level in enumerate(jm.levels):
        b = level.bands
        lv.append({
            "sys": jsw._system_to_arrays(level.sys), "mesh": meshes[i],
            "element": "P2" if i == 0 else "P1",
            "dinv": np.asarray(level.dinv),
            "t_cols": np.asarray(level.transfer.cols),
            "t_w": np.asarray(level.transfer.weights),
            "n_coarse": level.transfer.n_coarse,
            "tb_p": np.asarray(b[0].band), "tb_po": np.asarray(b[0].offs),
            "pad_p": b[1].n_cols_pad,
            "tb_r": np.asarray(b[2].band), "tb_ro": np.asarray(b[2].offs),
            "pad_r": b[3].n_cols_pad,
            "tb_sig": np.asarray(b[4]), "tb_isig": np.asarray(b[5])})
    carried = multilevel_from_arrays(lv, np.asarray(jm.Ainv),
                                     np.asarray(jm.free_c), jm.omega,
                                     np.asarray(jm.D_vec),
                                     np.asarray(jm.mu_vec), "cpu")
    assert all(l.sys.Advband is not None for l in carried.levels)
    R = np.random.default_rng(5).standard_normal(
        (jm.levels[0].sys.ndofs, 3)).astype(np.float32)
    M_fn, m_args = run.M
    ref = np.asarray(M_fn(m_args, jnp.asarray(R)))
    got = tml.make_ml_preconditioner(carried, cycle="mult")(
        torch.as_tensor(R)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, ref) < 1e-5


def _leaves(d, prefix=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(d, (float, int, np.floating)):
        yield prefix, float(d)


def test_advective_metrics_match_jax(run):
    """Batched metrics with the velocity, per-column D and mu, on the JAX
    solution: every leaf of every dict to 1e-10 relative (1e-13 absolute
    near zero), and the advective parts are really there."""
    from fenics_eff_uptake_tpu.analysis import batched_metrics as jbm
    from fenics_eff_uptake_tpu_torch.analysis import batched_metrics as tbm
    mus = [0.5, 1.0, 0.0]
    from fenics_eff_uptake_tpu_torch.studies.no_uptake import _make_params
    params = [j_make_params(pe, 0.25, 0.25) for pe in PES]
    sm_p = tbm.build_sweep_metrics(run.psys.space, run.tlevels[0], 1.0,
                                   "cpu", u=run.u)
    got = tbm.metrics_to_dicts(sm_p, run.tlevels[0], torch.tensor(run.Xj),
                               mus, [_make_params(pe, 0.25, 0.25)
                                     for pe in PES], D_values=run.D)
    uj = Function(FunctionSpace(run.mesh, "P2", vs=2),
                  jnp.asarray(run.u.values))
    sm_j = jbm.build_sweep_metrics(run.jsys.space, run.mesh, D=1.0, u=uj)
    ref = jbm.metrics_to_dicts(sm_j, run.mesh, jnp.asarray(run.Xj), mus,
                               1.0, params, D_values=run.D)
    for g_list, r_list in zip(got, ref):
        for g, r in zip(g_list, r_list):
            g, r = dict(_leaves(g)), dict(_leaves(r))
            assert g.keys() == r.keys()
            for k in r:
                if np.isnan(r[k]):
                    assert np.isnan(g[k]), k
                    continue
                assert abs(g[k] - r[k]) <= 1e-13 + 1e-10 * abs(r[k]), (
                    k, g[k], r[k])
    adv = got[0][0]["physical_flux"]["left"]["advective"]
    assert abs(adv) > 0.1

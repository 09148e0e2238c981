"""The port's step-mu (per-sample Robin) path against the JAX package.

A step-mu sweep gives every column its own Robin facet matrices, assembled
from a callable mu_b(x): on the fine system, on every level of the
hierarchy, and in the coarsest dense inverses.  Both packages run the
configuration the JAX package runs on a TPU (banded K and Adv, windowed
band transfers, banded level applies, the multiplicative V(1,1) cycle, up
to 12 f64 passes of f32 BiCGStab; JAX forced into it by the environment
tests/test_banded.py uses), on a rectangle with a seeded analytic velocity
and three StepUptakeOpen profiles, the 4-level hierarchy passed explicitly
(P2 -> P1 on the same mesh -> P1 at 0.3 -> P1 at 0.45).

Tolerances:
* Robin matrices of a callable mu, P2 and P1, and ``robin_matrices_for_mu``:
  1e-12 relative; JAX's are sliced to the true facets (it pads to its
  compile-key buckets, the port pads nothing);
* per-sample plain apply, ``_Block`` apply (full and out=) and
  ``diagonal_batched`` on seeded random A and X at nd 3 and 6: 1e-12
  relative in f64, 2e-5 in f32 (summation order); out= is bit-equal to
  apply-then-add;
* operator with a per-sample Robin block on JAX-carried arrays: 1e-12 in
  f64, 2e-5 in f32 (the band's summation order);
* one mult cycle with level Robin batches on the JAX hierarchy's own
  arrays: 1e-5 relative (f32 chains of band, transfer and element applies,
  as tests/test_torch_advective.py);
* solutions, on two meshes: 1e-9 absolute on true dofs; passes equal;
  per-column BiCGStab iterations within the spread JAX shows between its
  banded and element forms of the same fine operator, measured in the test;
* coarsest inverses: bit for bit, given JAX's coarse row count;
* ``transport_batch(steps=)`` at h = 0.07, where each package builds its
  own hierarchy: 1e-9 absolute (both solve to rtol 1e-12);
* mu_profiles metrics given the same X: 1e-10 relative.

The study itself is held against JAX's in
tests/test_torch_advdiff_study.py.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fenics_eff_uptake_tpu.analysis.profiles import eval_function
from fenics_eff_uptake_tpu.fem import assembly as jasm
from fenics_eff_uptake_tpu.fem.space import Function, FunctionSpace
from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu.meshing.mesh_data import MARKERS
from fenics_eff_uptake_tpu.parallel import sweep as jsw
from fenics_eff_uptake_tpu.params import StepUptakeOpen
from fenics_eff_uptake_tpu.solvers import multilevel as jml
from fenics_eff_uptake_tpu.studies import common as jcommon
from fenics_eff_uptake_tpu_torch.convert import (mesh_from,
                                                 multilevel_from_arrays,
                                                 robin_batch_from, space_from,
                                                 transport_system_from_arrays,
                                                 velocity_from_values)
from fenics_eff_uptake_tpu_torch.fem import assembly as tasm
from fenics_eff_uptake_tpu_torch.ops.elemspmv import (element_apply_plain,
                                                      make_scatter)
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw
from fenics_eff_uptake_tpu_torch.solvers import multilevel as tml
from fenics_eff_uptake_tpu_torch.studies import adv_diff as tadv
from fenics_eff_uptake_tpu_torch.studies import common as tcommon

torch.set_num_threads(2)

KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.5,
          refinement_factor=1, domain_type="rectangular")
TPU_ENV = {"FEU_ML_TBAND": "1", "FEU_ML_BAND": "1"}
PES = np.array([0.1, 1.0, 10.0])
RTOL = 1e-12


def _steps():
    """One smoothed step per column: base mu, mouth value, as the study
    makes them (mouth footprint 4.75..5.25, L_c = 0.1 w, Gamma = 5)."""
    return [StepUptakeOpen(mu_base=mb, mu_eff_target=mo, sulcus_left_x=4.75,
                           sulcus_right_x=5.25, L_c=0.05, Gamma=5.0)
            for mb, mo in ((0.1, 0.4), (1.0, 3.5), (10.0, 14.0))]


def _velocity(mesh):
    V = FunctionSpace(mesh, "P2", vs=2)
    xy = V.dof_coords
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * xy[:, 1] * (1.0 - xy[:, 1])
    u[1::2] = 0.3 * np.sin(xy[:, 0]) * xy[:, 1] * (1.0 - xy[:, 1])
    return u, V


def _jax_level_velocities(u, V, levels):
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


def _bottom(mesh):
    return mesh.bc_marker == MARKERS["bottom"]


def _jax_level_robin(levels, steps):
    """The JAX ``build_multilevel_for`` level Robin batches."""
    return [jnp.stack([jasm.robin_facet_block(FunctionSpace(m, "P1"),
                                              _bottom(m), mu=s).A_e
                       for s in steps]) for m in levels]


def _jax_sweep(mesh, levels, u, V, band):
    """JAX's step-mu sweep in its TPU configuration; ``band`` False swaps
    the fine banded operator for its element form.  Returns (system,
    hierarchy, fine Robin batch, X, info, f32 preconditioner)."""
    D = 1.0 / PES
    steps = _steps()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TPU_ENV.items():
            mp.setenv(k, v)
        mp.delenv("FEU_ML_CYCLE", raising=False)
        jsys = jsw.build_transport_system(mesh, u_values=jnp.asarray(u),
                                          u_space=V, pad_shapes=True,
                                          band=band)
        Rb = np.stack([np.asarray(jsw.robin_matrices_for_mu(jsys, s))
                       for s in steps])
        jm = jml.build_multilevel(
            jsys, levels, D, robin_matrices_levels=_jax_level_robin(levels,
                                                                    steps),
            robin_matrices_fine=jnp.asarray(Rb),
            u_levels=_jax_level_velocities(u, V, levels))
        Xj, ij = jsw.solve_sweep(jsys, D, robin_matrices=Rb, rtol=RTOL,
                                 precision="mixed", multilevel=jm)
        M = jml.make_ml_preconditioner(jm, f32=True)
    return jsys, jm, Rb, np.asarray(Xj), ij, M


def _port_sweep(mesh, levels, u):
    tmesh = mesh_from(mesh)
    tlevels = [tmesh] + [mesh_from(m) for m in levels[1:]]
    uf = velocity_from_values(u, tmesh)
    D = 1.0 / PES
    steps = _steps()
    psys = tsw.build_transport_system(tmesh, "cpu", u_values=uf.values,
                                      u_space=uf.space)
    Rb = torch.stack([tsw.robin_matrices_for_mu(psys, s) for s in steps])
    pml = tml.build_multilevel(
        psys, tlevels, D, u_levels=tml.level_velocities(uf, tlevels),
        robin_matrices_levels=tml.level_robin_matrices(tlevels, steps),
        robin_matrices_fine=Rb)
    Xp, ip = tsw.solve_sweep(psys, D, rtol=RTOL, multilevel=pml,
                             robin_matrices=Rb)
    return uf, psys, pml, Rb, Xp.numpy(), ip, tlevels


@pytest.fixture(scope="module")
def run():
    mesh, levels = _meshes(0.15)
    u, V = _velocity(mesh)
    jsys, jm, jRb, Xj, ij, M = _jax_sweep(mesh, levels, u, V, band=True)
    ij_elem = _jax_sweep(mesh, levels, u, V, band=False)[4]
    uf, psys, pml, pRb, Xp, ip, tlevels = _port_sweep(mesh, levels, u)
    return SimpleNamespace(mesh=mesh, levels=levels, tlevels=tlevels, u=uf,
                           D=1.0 / PES, jsys=jsys, jml=jm, jRb=jRb, Xj=Xj,
                           ij=ij, ij_elem=ij_elem, M=M, psys=psys, pml=pml,
                           pRb=pRb, Xp=Xp, ip=ip)


@pytest.fixture(scope="module")
def run_fine():
    """The sweeps alone on a second, finer mesh."""
    mesh, levels = _meshes(0.12)
    u, V = _velocity(mesh)
    out = _jax_sweep(mesh, levels, u, V, band=True)
    ij_elem = _jax_sweep(mesh, levels, u, V, band=False)[4]
    Xp, ip = _port_sweep(mesh, levels, u)[4:6]
    return SimpleNamespace(Xj=out[3], ij=out[4], ij_elem=ij_elem, Xp=Xp,
                           ip=ip)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("element", ["P2", "P1"])
def test_callable_mu_robin_matrices_match_jax(element):
    mesh = generate_mesh(mesh_size=0.15, **KW)
    sp = FunctionSpace(mesh, element)
    for step in _steps():
        ref = jasm.robin_facet_block(sp, _bottom(mesh), mu=step)
        A_e, dofs = tasm.robin_facet_block(space_from(sp), _bottom(mesh),
                                           "cpu", mu=step)
        np.testing.assert_array_equal(dofs, np.asarray(ref.entity_dofs))
        assert _rel(A_e.numpy(), np.asarray(ref.A_e)) < 1e-12
    # a negative mu(x) is clamped at 0, and the quadrature is not the unit
    # block's: a varying mu differs from its mean times the unit block
    unit = tasm.robin_facet_block(space_from(sp), _bottom(mesh), "cpu")[0]
    neg = tasm.robin_facet_block(space_from(sp), _bottom(mesh), "cpu",
                                 mu=lambda x: -1.0 + 0.0 * x)[0]
    assert float(neg.abs().max()) == 0.0
    two = tasm.robin_facet_block(space_from(sp), _bottom(mesh), "cpu",
                                 mu=lambda x: 2.0 + 0.0 * x)[0]
    assert _rel(two.numpy(), 2.0 * unit.numpy()) < 1e-12


def test_robin_matrices_for_mu_match_jax(run):
    """Facet for facet JAX's, sliced to the true facets (JAX pads to the
    system's bucketed facet count)."""
    F = run.psys.R.A64.shape[0]
    assert run.jRb.shape[1] >= F == tuple(run.pRb.shape)[1]
    assert _rel(run.pRb.numpy(), run.jRb[:, :F]) < 1e-12
    assert float(np.abs(run.jRb[:, F:]).max(initial=0.0)) == 0.0
    n = run.psys.space.ndofs
    np.testing.assert_array_equal(
        run.psys.perm[:n][run.psys.R.dofs.numpy()],
        np.asarray(run.jsys.perm)[:n][np.asarray(run.jsys.R.dofs)[:F]])


@pytest.mark.parametrize("nd", [3, 6])
@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_per_sample_block_matches_jax(nd, f32):
    """Seeded random per-sample A and X through JAX's ``_Block`` (its
    unrolled multiply-adds) and the port's plain apply and ``_Block``."""
    rng = np.random.default_rng(10 * nd + f32)
    B, N, n = 5, 37, 64
    dofs = np.stack([rng.permutation(n - 4)[:nd] for _ in range(N)])
    A = rng.standard_normal((B, N, nd, nd))
    unit = rng.standard_normal((N, nd, nd))
    X = rng.standard_normal((n, B))
    perm = np.argsort(dofs.ravel(), kind="stable")
    jb = jsw._Block(A64=jnp.asarray(unit),
                    A32=jnp.asarray(unit, dtype=jnp.float32),
                    dofs=jnp.asarray(dofs), perm=jnp.asarray(perm),
                    ids_sorted=jnp.asarray(dofs.ravel()[perm]), ndofs=n)
    dt, tol = (np.float32, 2e-5) if f32 else (np.float64, 1e-12)
    ref = np.asarray(jb.apply_batched(jnp.asarray(X.astype(dt)), f32=f32,
                                      A_override=jnp.asarray(A.astype(dt))))
    Xt = torch.as_tensor(X.astype(dt))
    At = torch.as_tensor(A.astype(dt))
    blk = tsw._Block.build(torch.as_tensor(unit), dofs, n)
    got = element_apply_plain(At, blk.dofs, make_scatter(dofs, n, "cpu"), Xt)
    assert got.dtype == Xt.dtype and _rel(got.numpy(), ref) < tol
    ps = blk.per_sample(A)
    assert ps.kernels is None and ps.A64.dim() == 4
    full = ps.apply_batched(Xt)
    assert torch.equal(full, got)
    out0 = torch.as_tensor(rng.standard_normal((n, B)).astype(dt))
    added = ps.apply_batched(Xt, out=out0.clone())
    assert torch.equal(added, out0 + full)
    assert _rel(ps.diagonal().numpy(),
                np.asarray(jb.diagonal_batched(jnp.asarray(A)))) < 1e-12
    assert torch.equal(ps.diagonal(),
                       blk.diagonal_batched(torch.as_tensor(A)))
    # a per-sample block takes its own batch size and no coef
    with pytest.raises(ValueError):
        ps.apply_batched(Xt[:, :3].contiguous())
    with pytest.raises(ValueError):
        ps.apply_batched(Xt, coef=torch.ones(B, dtype=Xt.dtype))
    with pytest.raises(ValueError):
        blk.per_sample(A[:, :-1])


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_step_mu_operator_matches_jax(run, f32):
    carried = transport_system_from_arrays(
        jsw._system_to_arrays(run.jsys), run.mesh, "P2", "cpu")
    Rb = robin_batch_from(carried, run.jRb)
    dt = np.float32 if f32 else np.float64
    X = np.random.default_rng(0).standard_normal(
        (run.jsys.ndofs, 3)).astype(dt)
    A_fn = jsw._operator_program(jsw.sys_struct_key(run.jsys))[0]
    zeros = np.zeros(3)
    a = jsw.operator_args(run.jsys, jnp.asarray(run.D), jnp.asarray(zeros),
                          jnp.asarray(run.jRb), f32=f32)
    ref = np.asarray(A_fn(a, jnp.asarray(X)))
    args = tsw.operator_args(carried, run.D, zeros, f32=f32, R_batch=Rb)
    got = tsw.apply_operator(args, torch.as_tensor(X))
    assert got.numpy().dtype == dt
    assert _rel(got.numpy(), ref) < (2e-5 if f32 else 1e-12)
    # R adds in place with the rounding of the separate apply and add
    free = carried.free[:, None]
    Xm = torch.where(free, torch.as_tensor(X), 0.0)
    base = tsw._apply_raw(args._replace(R_batch=None, R=None), Xm)
    apart = torch.where(free, base + Rb.apply_batched(Xm), torch.as_tensor(X))
    assert torch.equal(got, apart)
    # and the per-sample block is really in the operator
    shared = tsw.apply_operator(tsw.operator_args(carried, run.D, zeros,
                                                  f32=f32),
                                torch.as_tensor(X))
    assert _rel(shared.numpy(), ref) > 1e-3
    dref = np.asarray(jml._fine_dinv(run.jsys, jnp.asarray(run.D),
                                     jnp.asarray(zeros),
                                     jnp.asarray(run.jRb)))
    dinv = tsw.fine_dinv(carried, run.D, zeros, robin_matrices=run.jRb)
    assert _rel(dinv.numpy(), dref) < 1e-6


@pytest.mark.parametrize("case", ["run", "run_fine"],
                         ids=["h0.15", "h0.12"])
def test_step_mu_sweep_matches_jax(request, case):
    r = request.getfixturevalue(case)
    assert r.Xp.shape == r.Xj.shape
    assert float(np.abs(r.Xp - r.Xj).max()) < 1e-9
    assert r.ip["passes"] == r.ij["passes"] == r.ij_elem["passes"]
    it_p = np.asarray(r.ip["iters"])
    it_j = np.asarray(r.ij["iters"])
    spread = int(np.abs(np.asarray(r.ij_elem["iters"]) - it_j).max())
    assert (np.abs(it_p - it_j) <= spread).all(), (it_p, it_j, spread)
    assert (r.ip["rel_resnorm"] <= RTOL).all()


def test_solve_sweep_binds_the_fine_robin_batch_once(run, monkeypatch):
    """Given the tensor the hierarchy's fine level was built from, the
    solve uses that level's block; given a copy, it binds its own, and the
    columns come out the same bit for bit."""
    made = []
    per_sample = tsw._Block.per_sample
    monkeypatch.setattr(tsw._Block, "per_sample",
                        lambda self, A: made.append(A) or per_sample(self, A))
    assert run.pml.levels[0].R_batch.A64 is run.pRb
    X0, _ = tsw.solve_sweep(run.psys, run.D, rtol=1e-3, multilevel=run.pml,
                            robin_matrices=run.pRb)
    assert made == []
    X1, _ = tsw.solve_sweep(run.psys, run.D, rtol=1e-3, multilevel=run.pml,
                            robin_matrices=run.pRb.clone())
    assert len(made) == 1
    assert torch.equal(X0, X1)


def test_step_mu_hierarchy_matches_jax(run):
    """Level Robin batches on each level's own facets (1e-12), level
    inverse diagonals with them (f32, 1e-6), and the cycle's f32 copies
    equal to JAX's."""
    assert len(run.pml.levels) == len(run.jml.levels) == 3
    for pl, jl, jRb in zip(run.pml.levels, run.jml.levels,
                           run.jml.R_batches):
        n = pl.sys.space.ndofs
        assert _rel(pl.dinv.numpy()[:n], np.asarray(jl.dinv)[:n]) < 1e-6
        F = pl.sys.R.A64.shape[0]
        assert pl.R_batch is not None and pl.R_batch.A64.shape[1] == F
        jRb = np.asarray(jRb)
        assert jRb.dtype == np.float32
        assert _rel(pl.R_batch.A32.numpy(), jRb[:, :F]) < 1e-6
        assert _rel(pl.R_batch.A64.numpy(), jRb[:, :F]) < 1e-6
    # a step is not its base value: the level batch differs from mu * unit
    l1 = run.pml.levels[1]
    assert _rel(l1.R_batch.A64[1].numpy(), l1.sys.R.A64.numpy()) > 1e-2


def test_step_mu_coarse_inverse_matches_jax(run):
    """The per-column coarsest inverses (constrained per-sample Robin,
    symmetrised constrained Adv, 1e-6 mean-|diagonal| shift, f32 inverse)
    equal JAX's bit for bit once the port's coarsest system carries JAX's
    padding rows."""
    steps = _steps()
    uv, us = tml.level_velocities(run.u, run.tlevels)[-1]
    csys = tsw.build_transport_system(run.tlevels[-1], "cpu", element="P1",
                                      u_values=uv, u_space=us)
    Rb_c = tml.level_robin_matrices(run.tlevels, steps)[-1]
    jA = np.asarray(run.jml.Ainv)
    nj = jA.shape[1]
    assert nj > csys.ndofs
    padded = csys._replace(ndofs=nj, free=torch.cat(
        [csys.free, torch.zeros(nj - csys.ndofs, dtype=torch.bool)]))
    np.testing.assert_array_equal(
        tml._coarse_inverses(padded, run.D, np.zeros(3),
                             robin_matrices=Rb_c), jA)
    own = run.pml.Ainv.numpy()
    n = own.shape[1]
    assert _rel(own[:2], jA[:2, :n, :n]) < 2e-5
    assert _rel(own[2], jA[2, :n, :n]) < 1e-3
    # without the batch the inverses are others
    plain = tml._coarse_inverses(padded, run.D, np.zeros(3))
    assert _rel(plain, jA) > 1e-3


def test_step_mu_cycle_on_carried_state_matches_jax(run):
    """One multiplicative V(1,1) cycle of the port on the JAX step-mu
    hierarchy's own arrays, level Robin batches included, equals JAX's."""
    jm = run.jml
    lv = []
    for i, level in enumerate(jm.levels):
        b = level.bands
        lv.append({
            "sys": jsw._system_to_arrays(level.sys), "mesh": run.levels[i],
            "element": "P2" if i == 0 else "P1",
            "dinv": np.asarray(level.dinv),
            "t_cols": np.asarray(level.transfer.cols),
            "t_w": np.asarray(level.transfer.weights),
            "n_coarse": level.transfer.n_coarse,
            "tb_p": np.asarray(b[0].band), "tb_po": np.asarray(b[0].offs),
            "pad_p": b[1].n_cols_pad,
            "tb_r": np.asarray(b[2].band), "tb_ro": np.asarray(b[2].offs),
            "pad_r": b[3].n_cols_pad,
            "tb_sig": np.asarray(b[4]), "tb_isig": np.asarray(b[5]),
            "R_batch": np.asarray(jm.R_batches[i])})
    carried = multilevel_from_arrays(lv, np.asarray(jm.Ainv),
                                     np.asarray(jm.free_c), jm.omega,
                                     np.asarray(jm.D_vec),
                                     np.asarray(jm.mu_vec), "cpu")
    assert all(l.R_batch is not None for l in carried.levels)
    R = np.random.default_rng(5).standard_normal(
        (jm.levels[0].sys.ndofs, 3)).astype(np.float32)
    M_fn, m_args = run.M
    ref = np.asarray(M_fn(m_args, jnp.asarray(R)))
    got = tml.make_ml_preconditioner(carried, cycle="mult")(
        torch.as_tensor(R)).numpy()
    assert got.dtype == np.float32
    assert _rel(got, ref) < 1e-5
    # the same cycle without the batches is another operator
    bare = carried._replace(levels=tuple(l._replace(R_batch=None)
                                         for l in carried.levels))
    other = tml.make_ml_preconditioner(bare, cycle="mult")(
        torch.as_tensor(R)).numpy()
    assert _rel(other, ref) > 1e-4


def _leaves(d, prefix=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(d, (float, int, np.floating)):
        yield prefix, float(d)


def test_mu_profile_metrics_match_jax(run):
    """Batched metrics with per-column mu(x) tables on the JAX solution:
    every leaf to 1e-10 relative, and the uptake is the profiles'."""
    from fenics_eff_uptake_tpu.analysis import batched_metrics as jbm
    from fenics_eff_uptake_tpu_torch.analysis import batched_metrics as tbm
    steps = _steps()
    params = [tadv.create_base_parameters(pe, 1.0, 0.15) for pe in PES]
    sm_p = tbm.build_sweep_metrics(run.psys.space, run.tlevels[0], 1.0,
                                   "cpu", u=run.u, mu_profiles=steps)
    got = tbm.metrics_to_dicts(sm_p, run.tlevels[0], torch.tensor(run.Xj),
                               [0.0] * 3, params, D_values=run.D)
    uj = Function(FunctionSpace(run.mesh, "P2", vs=2),
                  jnp.asarray(run.u.values))
    sm_j = jbm.build_sweep_metrics(run.jsys.space, run.mesh, D=1.0, u=uj,
                                   mu_profiles=steps)
    ref = jbm.metrics_to_dicts(sm_j, run.mesh, jnp.asarray(run.Xj),
                               [0.0] * 3, 1.0, params, D_values=run.D)
    for g_list, r_list in zip(got[:2], ref[:2]):
        for g, r in zip(g_list, r_list):
            g, r = dict(_leaves(g)), dict(_leaves(r))
            assert g.keys() == r.keys()
            for k in r:
                assert abs(g[k] - r[k]) <= 1e-13 + 1e-10 * abs(r[k]), (
                    k, g[k], r[k])
    assert all(fm["uptake_flux"] > 0.01 for fm in got[0])
    # with mu_vec = 0 and no profiles the uptake would vanish
    sm_0 = tbm.build_sweep_metrics(run.psys.space, run.tlevels[0], 1.0,
                                   "cpu", u=run.u)
    none = tbm.metrics_to_dicts(sm_0, run.tlevels[0], torch.tensor(run.Xj),
                                [0.0] * 3, params, D_values=run.D)
    assert all(fm["uptake_flux"] == 0.0 for fm in none[0])


def test_transport_batch_steps_matches_jax():
    """``transport_batch(steps=)`` at h = 0.07, below the hierarchy
    threshold: each package assembles its own level Robin batches from the
    callables.  JAX runs its CPU default here (f64 BiCGStab, its own
    cycle); both solve to rtol 1e-12."""
    mesh = generate_mesh(mesh_size=0.07, **KW)
    u, V = _velocity(mesh)
    D = list(1.0 / PES)
    steps = _steps()
    Xj, ij, _ = jcommon.transport_batch(
        mesh, Function(V, jnp.asarray(u)), D, steps=steps, rtol=RTOL)
    tmesh = mesh_from(mesh)
    Xp, ip, psys, stats = tcommon.transport_batch(
        tmesh, velocity_from_values(u, tmesh), D, None, "cpu", rtol=RTOL,
        steps=steps)
    assert stats["multilevel"]
    assert (ip["rel_resnorm"] <= RTOL).all()
    assert float(np.abs(Xp.numpy() - np.asarray(Xj)).max()) < 1e-9
    assert int(np.max(ip["iters"])) < 300

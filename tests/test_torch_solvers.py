"""The port's single-system Krylov solvers and the FEM checks of the
per-run path, against the JAX package on the CPU.

* ``cg``, ``bicgstab``, ``gmres`` (with and without Jacobi) and
  ``refined_solve`` (CG and BiCGStab inner) on the same seeded dense SPD and
  nonsymmetric systems (``tests/test_solvers.py``'s): iterations within 2
  of the JAX solver's, x within 1e-10 of it (max abs).
* The FEM checks of ``tests/test_fem.py``: Jacobi CG on the diffusion +
  Robin system against scipy's direct solve (1e-9), the P1 and P2
  manufactured-solution rates through ``load_vector`` and ``l2_error``
  (within 0.25 of 2 and 3), and the exactness of a linear solution
  (1e-10); ``load_vector``, ``l2_error``, ``vector_stiffness_block`` and
  ``make_bc`` with callable values against the JAX package's (1e-13).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fenics_eff_uptake_tpu_torch.solvers.bicgstab import bicgstab
from fenics_eff_uptake_tpu_torch.solvers.cg import cg, jacobi_preconditioner
from fenics_eff_uptake_tpu_torch.solvers.gmres import gmres
from fenics_eff_uptake_tpu_torch.solvers.mixed import refined_solve

torch.set_num_threads(2)


def _spd(n, seed=0):
    rng = np.random.RandomState(seed)
    A = sp.random(n, n, density=0.05, random_state=rng)
    return (A + A.T).toarray() + n * np.eye(n)


def _nonsym(n, seed=0):
    A = _spd(n, seed)
    rng = np.random.RandomState(seed + 1)
    return A + 0.5 * rng.randn(n, n) / np.sqrt(n)


@pytest.fixture(scope="module")
def jsolvers():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenics_eff_uptake_tpu.solvers import (bicgstab, cg, gmres,
                                               refined_solve)
    return jnp, dict(cg=cg, bicgstab=bicgstab, gmres=gmres,
                     refined_solve=refined_solve)


def _ops(A):
    At = torch.as_tensor(A)
    dinv = torch.as_tensor(1.0 / np.diag(A))
    return (lambda x: At @ x), (lambda r: dinv * r)


@pytest.mark.parametrize("name,kind,precond", [
    ("cg", "spd", False), ("cg", "spd", True),
    ("bicgstab", "nonsym", False), ("bicgstab", "nonsym", True),
    ("gmres", "nonsym", False), ("gmres", "nonsym", True)])
def test_krylov_matches_jax(jsolvers, name, kind, precond):
    jnp, js = jsolvers
    n = 150
    A = (_spd if kind == "spd" else _nonsym)(n, seed=5)
    # a spread diagonal, so that Jacobi changes the iteration
    A = A + np.diag(np.linspace(0.0, 3.0 * n, n))
    b = np.random.RandomState(2).randn(n)
    kw = dict(rtol=1e-12)
    if name == "gmres":
        kw["restart"] = 25
    Aj = jnp.asarray(A)
    dj = jnp.asarray(1.0 / np.diag(A))
    rj = js[name](lambda x: Aj @ x, jnp.asarray(b),
                  M=(lambda r: dj * r) if precond else None, **kw)
    A_t, M_t = _ops(A)
    rt = {"cg": cg, "bicgstab": bicgstab, "gmres": gmres}[name](
        A_t, torch.as_tensor(b), M=M_t if precond else None, **kw)
    assert rt.converged and bool(rj.converged)
    assert abs(int(rt.iters) - int(rj.iters)) <= 2, (rt.iters, rj.iters)
    assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() < 1e-10
    assert np.abs(rt.x.numpy() - np.linalg.solve(A, b)).max() < 1e-8


@pytest.mark.parametrize("nonsymmetric", [False, True])
def test_refined_solve_matches_jax(jsolvers, nonsymmetric):
    jnp, js = jsolvers
    n = 120
    A = _nonsym(n, seed=3) if nonsymmetric else _spd(n, seed=3)
    b = np.random.RandomState(4).randn(n)
    A32 = A.astype(np.float32)
    dinv32 = (1.0 / np.diag(A)).astype(np.float32)
    Aj, Aj32, dj = jnp.asarray(A), jnp.asarray(A32), jnp.asarray(dinv32)
    rj = js["refined_solve"](lambda x: Aj @ x, lambda x: Aj32 @ x,
                             jnp.asarray(b), M32=lambda r: dj * r,
                             rtol=1e-12, nonsymmetric=nonsymmetric)
    At, At32, dt = (torch.as_tensor(a) for a in (A, A32, dinv32))
    rt = refined_solve(lambda x: At @ x, lambda x: At32 @ x,
                       torch.as_tensor(b), M32=lambda r: dt * r,
                       rtol=1e-12, nonsymmetric=nonsymmetric)
    assert rt.converged and bool(rj.converged)
    assert rt.refinements == int(rj.refinements)
    assert abs(rt.inner_iters - int(rj.inner_iters)) <= 2 * rt.refinements
    assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() < 1e-10


def test_jacobi_preconditioner_is_identity_where_constrained():
    diag = torch.tensor([2.0, 0.0, 4.0, 5.0], dtype=torch.float64)
    M = jacobi_preconditioner(diag, np.array([True, True, False, True]))
    assert M(torch.ones(4, dtype=torch.float64)).tolist() == [0.5, 1.0, 1.0,
                                                              0.2]


# ---------------------------------------------------------------------------
# the FEM checks of the per-run path
# ---------------------------------------------------------------------------

def test_cg_matches_scipy_direct_with_robin():
    """Jacobi CG on the diffusion + Robin system equals scipy's direct solve
    of the same eliminated system (assembled from the port's blocks)."""
    import scipy.sparse.linalg as spla
    from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace
    from fenics_eff_uptake_tpu_torch.meshing.generator import \
        structured_rectangle
    from fenics_eff_uptake_tpu_torch.models.diffusion import \
        build_diffusion_system
    md = structured_rectangle(2.0, 1.0, 10, 5)
    space = FunctionSpace(md, "P2")
    ls = build_diffusion_system(space, D=1.0, mu=2.0, device="cpu")
    res = cg(ls.apply, ls.rhs, M=ls.precond, rtol=1e-14)
    assert res.converged
    n = space.ndofs
    rows, cols, vals = [], [], []
    for blk in ls.op.blocks:
        d = blk.dofs.long().numpy()
        N, nd = d.shape
        rows.append(np.repeat(d, nd, axis=1).ravel())
        cols.append(np.tile(d, (1, nd)).ravel())
        vals.append(blk.A64.numpy().ravel())
    A = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(n, n)).tocsr()
    x = np.random.RandomState(0).randn(n)
    assert np.abs(A @ x - ls.op.apply(torch.as_tensor(x)).numpy()).max() \
        < 1e-12
    free, g = ls.bc.free, ls.bc.values
    b = -(A @ g)
    A = A.tolil()
    for i in np.flatnonzero(~free):
        A[i, :] = 0.0
        A[:, i] = 0.0
        A[i, i] = 1.0
    b[~free] = g[~free]
    x_direct = spla.spsolve(A.tocsc(), b)
    assert np.abs(res.x.numpy() - x_direct).max() < 1e-9


@pytest.mark.parametrize("elem,rate", [("P1", 2.0), ("P2", 3.0)])
def test_manufactured_solution_rates(elem, rate):
    """-lap u = f, u = sin(pi x) sin(pi y) on [0, 1]^2, Dirichlet on every
    wall: the L2 error falls at rate 2 (P1) and 3 (P2)."""
    from fenics_eff_uptake_tpu_torch.analysis.integrals import l2_error
    from fenics_eff_uptake_tpu_torch.fem.assembly import (
        constrained_operator, constrained_rhs, load_vector, make_bc)
    from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace
    from fenics_eff_uptake_tpu_torch.meshing.generator import \
        structured_rectangle
    from fenics_eff_uptake_tpu_torch.models.diffusion import (
        ElementSum, _Block)
    from fenics_eff_uptake_tpu_torch.fem.assembly import stiffness_block

    def u_ex(x, y):
        return np.sin(np.pi * x) * np.sin(np.pi * y)

    def f(x, y):
        return 2 * np.pi ** 2 * np.sin(np.pi * x) * np.sin(np.pi * y)

    errs, hs = [], []
    for n in (4, 8, 16):
        md = structured_rectangle(1.0, 1.0, n, n)
        space = FunctionSpace(md, elem)
        K_e, dofs = stiffness_block(space, "cpu")
        op = ElementSum((_Block.build(K_e, dofs, space.ndofs),),
                        space.ndofs)
        bc = make_bc(space, [(m, 0.0) for m in (1, 2, 3, 4)])
        b = load_vector(space, f, "cpu", degree=6)
        res = cg(constrained_operator(op, bc), constrained_rhs(op, bc, b),
                 M=jacobi_preconditioner(op.diagonal(), bc.free),
                 rtol=1e-14)
        errs.append(l2_error(space, res.x, u_ex))
        hs.append(1.0 / n)
    rates = np.diff(np.log(errs)) / np.diff(np.log(hs))
    assert rates.min() > rate - 0.25, (errs, rates)


def test_linear_solution_is_exact():
    """mu = 0: c = 1 - x/2 lies in P1 and P2, so the per-run solve (the
    batched engine at B = 1) reproduces it."""
    from fenics_eff_uptake_tpu_torch.meshing.generator import \
        structured_rectangle
    from fenics_eff_uptake_tpu_torch.models.diffusion import \
        pure_diffusion_solve
    md = structured_rectangle(2.0, 1.0, 8, 4)
    for elem in ("P1", "P2"):
        c = pure_diffusion_solve(md, "cpu", D=1.0, mu=0.0, element=elem)
        exact = 1.0 - np.asarray(c.space.dof_coords)[:, 0] / 2.0
        assert np.abs(c.as_numpy() - exact).max() < 1e-10, elem
        assert c.solver_info["converged"]


def test_fem_host_pieces_match_jax():
    """load_vector, l2_error, vector_stiffness_block and make_bc (callable
    vector values, another marker array) against the JAX package's."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from fenics_eff_uptake_tpu.analysis.integrals import l2_error as jl2
    from fenics_eff_uptake_tpu.fem import assembly as ja
    from fenics_eff_uptake_tpu.fem.space import FunctionSpace as JFS
    from fenics_eff_uptake_tpu.meshing.generator import \
        structured_rectangle as jrect
    from fenics_eff_uptake_tpu_torch.analysis.integrals import l2_error
    from fenics_eff_uptake_tpu_torch.fem import assembly as ta
    from fenics_eff_uptake_tpu_torch.fem.space import FunctionSpace
    from fenics_eff_uptake_tpu_torch.meshing.generator import \
        structured_rectangle

    def f(x, y):
        return np.exp(x) * np.cos(3 * y)

    for elem in ("P1", "P2"):
        jsp, tsp = JFS(jrect(2.0, 1.0, 6, 4), elem), \
            FunctionSpace(structured_rectangle(2.0, 1.0, 6, 4), elem)
        bj = np.asarray(ja.load_vector(jsp, f, degree=5))
        bt = ta.load_vector(tsp, f, "cpu", degree=5).numpy()
        assert np.abs(bt - bj).max() < 1e-13 * np.abs(bj).max()
        v = np.random.RandomState(1).randn(tsp.ndofs)
        assert l2_error(tsp, v, f) == pytest.approx(
            jl2(jsp, jnp.asarray(v), f), rel=1e-13)
    jV = JFS(jrect(2.0, 1.0, 6, 4), "P2", vs=2)
    tV = FunctionSpace(structured_rectangle(2.0, 1.0, 6, 4), "P2", vs=2)
    Aj = np.asarray(ja.vector_stiffness_block(jV, coeff=0.7).A_e)
    At, dofs = ta.vector_stiffness_block(tV, "cpu", coeff=0.7)
    assert np.abs(At.numpy() - Aj).max() < 1e-13 * np.abs(Aj).max()
    assert np.array_equal(dofs, np.asarray(jV.cell_dofs))

    def inflow(x, y):
        return np.stack([4.0 * y * (1.0 - y), 0.5 * x], axis=1)

    marks = np.where(tV.mesh.bc_marker == 3, 4, tV.mesh.bc_marker)
    for arr in (None, marks):
        pairs = [(1, inflow), (4, 0.25)]
        bj = ja.make_bc(jV, pairs, marker_array=arr)
        bt = ta.make_bc(tV, pairs, marker_array=arr)
        assert np.array_equal(bt.free, np.asarray(bj.free))
        assert np.array_equal(bt.values, np.asarray(bj.values))

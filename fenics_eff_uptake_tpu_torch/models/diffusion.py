"""Steady pure-diffusion concentration solves with Robin uptake
(counterpart of ``models/diffusion.py``):

  weak form:  D grad(c) . grad(phi) dx + mu(x) c phi ds_4
  BCs:        c = 1 on the left wall (marker 1), c = 0 on the right (2),
              Robin on the whole bottom (marker 4).

A single run goes through the batched engine at B = 1
(``parallel/sweep.py``): ``build_transport_system``, the multigrid
hierarchy (``build_multilevel_for``; None at h >= 0.08, and then the
two-level preconditioner of a given ``coarse_mesh``, else Jacobi) and
``solve_sweep``, so one code path serves single runs and sweeps, and every
operator apply runs in the three hand kernels (A: the f32 band operator
and mid-level smoothing; B: the transfers; C: the f64 defect residuals and
the Robin ``out=`` adds).  A scalar mu scales the unit Robin block per
column (``mu_values``); a callable mu(x) takes its own Robin matrices on
every level (``robin_matrices_for_mu``, ``mu_callables``).

``solver="gmres"`` (or ``"auto"`` with advection at Pe = 1/D > 25) routes
through restarted GMRES (``solvers/gmres.py``) on the f64 operator, every
apply in kernel C in f64 at B = 1, with Jacobi preconditioning.

After the solve, non-finite values become 0 and a tiny negative minimum
(|min| < 1e-12) is clamped to 0, as in the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..device import setup
from ..fem.assembly import (BCData, advection_block, constrained_operator,
                            constrained_rhs, make_bc, robin_facet_block,
                            stiffness_block)
from ..fem.space import Function, FunctionSpace
from ..meshing.mesh_data import MARKERS, MeshData
from ..parallel.sweep import (_Block, apply_operator,
                              build_transport_system, fine_dinv,
                              operator_args, operator_rhs,
                              robin_matrices_for_mu, solve_sweep,
                              unpermute_columns)
from ..solvers.cg import jacobi_preconditioner
from ..solvers.gmres import gmres
from ..solvers.multilevel import build_multilevel_for

__all__ = ["build_diffusion_system", "pure_diffusion_solve",
           "ElementSum", "LinearSystem"]

GMRES_RESTART = 60
GMRES_PE = 25.0     # solver="auto" takes GMRES above this Peclet number


class ElementSum(NamedTuple):
    """A sum of element blocks on one scalar space (its own dof numbering,
    nothing padded): ``apply`` (ndofs,) -> (ndofs,) in x's dtype through
    each block's kernel C at B = 1, in block order; ``diagonal`` f64."""
    blocks: tuple
    ndofs: int

    def apply(self, x):
        X = x[:, None]
        Y = self.blocks[0].apply_batched(X)
        for b in self.blocks[1:]:
            Y = Y + b.apply_batched(X)
        return Y[:, 0]

    def diagonal(self):
        return sum(b.diagonal() for b in self.blocks)


class LinearSystem(NamedTuple):
    op: ElementSum
    bc: BCData
    apply: Callable
    rhs: torch.Tensor
    precond: Callable
    space: FunctionSpace


def build_diffusion_system(space: FunctionSpace, D, mu, device="cpu",
                           u_values=None, u_space=None) -> LinearSystem:
    """The (advection-)diffusion + Robin operator with the Dirichlet
    conditions eliminated, its right-hand side and Jacobi preconditioner,
    for a single-system Krylov solve (``solvers/cg.py``); the tests' and
    the CPU cross-checks' form (the runs go through the batched
    engine)."""
    device = setup(device)
    mesh = space.mesh
    n = space.ndofs
    K_e, dofs = stiffness_block(space, device)
    blocks = [_Block.build(K_e * float(D), dofs, n)]
    if u_values is not None:
        A_e, _ = advection_block(space, u_values, u_space, device)
        blocks.append(_Block.build(A_e, dofs, n))
    bottom = mesh.bc_marker == MARKERS["bottom"]
    if bottom.any():
        if np.isscalar(mu):
            R_e, rd = robin_facet_block(space, bottom, device)
            R_e = R_e * float(mu)
        else:
            R_e, rd = robin_facet_block(space, bottom, device, mu=mu)
        blocks.append(_Block.build(R_e, rd, n))
    op = ElementSum(tuple(blocks), n)
    bc = make_bc(space, [(MARKERS["left"], 1.0), (MARKERS["right"], 0.0)])
    return LinearSystem(
        op=op, bc=bc, apply=constrained_operator(op, bc),
        rhs=constrained_rhs(op, bc, device=device),
        precond=jacobi_preconditioner(op.diagonal(), bc.free), space=space)


def _finish(sys_t, vals, info):
    """The solution Function: non-finite values to 0, a tiny negative
    minimum (|min| < 1e-12) clamped to 0; ``solver_info`` attached."""
    vals = torch.where(torch.isfinite(vals), vals, 0.0)
    mn = float(vals.min())
    if mn < 0 and abs(mn) < 1e-12:
        vals = torch.clamp(vals, min=0.0)
    fn = Function(sys_t.space, vals)
    fn.solver_info = info
    return fn


def _transport_solve(mesh: MeshData, device, D, mu, element, rtol,
                     maxiter=None, u=None, solver=None,
                     solver_options=None, coarse_mesh=None) -> Function:
    """One transport solve at B = 1; ``u`` the velocity Function (numpy
    values on the P2 vector space) or None; ``coarse_mesh`` preconditions
    through the two-level preconditioner where no hierarchy is built."""
    from ..studies.common import split_solver_options
    device = setup(device)
    D = float(D)
    sys_t = build_transport_system(
        mesh, device, element, u_values=None if u is None else u.values,
        u_space=None if u is None else u.space)
    if solver == "auto":
        solver = ("gmres" if u is not None and D > 0 and 1.0 / D > GMRES_PE
                  else None)
    if solver == "gmres":
        return _gmres_transport_solve(sys_t, D, mu, rtol, maxiter)
    if solver is not None:
        raise ValueError(f"unknown solver {solver!r}")
    build_kw, solve_kw = split_solver_options(solver_options)
    if np.isscalar(mu):
        ml = build_multilevel_for(sys_t, mesh, [D], mu_values=[float(mu)],
                                  u_fine=u, **build_kw)
        X, info = solve_sweep(sys_t, [D], mu_values=[float(mu)], rtol=rtol,
                              multilevel=ml,
                              coarse_mesh=None if ml is not None
                              else coarse_mesh, **solve_kw)
    else:
        R = robin_matrices_for_mu(sys_t, mu)[None]
        ml = build_multilevel_for(sys_t, mesh, [D], mu_callables=[mu],
                                  robin_matrices_fine=R, u_fine=u,
                                  **build_kw)
        X, info = solve_sweep(sys_t, [D], robin_matrices=R, rtol=rtol,
                              multilevel=ml,
                              coarse_mesh=None if ml is not None
                              else coarse_mesh, **solve_kw)
    return _finish(sys_t, X[0], {
        "iters": int(info["iters"][0]),
        "resnorm": float(info["resnorm"][0]),
        "converged": bool(info["converged"][0]),
        "rel_resnorm": float(info["true_rel_resnorm"][0]),
        "passes": info.get("passes"),
        "multilevel": ml is not None,
        "twolevel": ml is None and coarse_mesh is not None})


def _gmres_transport_solve(sys_t, D, mu, rtol, maxiter) -> Function:
    """Restarted GMRES on the f64 operator (kernel C at B = 1), Jacobi
    preconditioned, from x0 = 0."""
    R = None
    if np.isscalar(mu):
        Rb, mu_vec = None, [float(mu)]
    else:
        R = robin_matrices_for_mu(sys_t, mu)[None]
        Rb, mu_vec = sys_t.R.per_sample(R), [0.0]
    a = operator_args(sys_t, [D], mu_vec, f32=False, R_batch=Rb)
    rhs = operator_rhs(a, sys_t.bc_values[:, None])[:, 0]
    dinv = fine_dinv(sys_t, [D], mu_vec, R, dtype=torch.float64)[:, 0]

    def A(x):
        return apply_operator(a, x[:, None])[:, 0]

    res = gmres(A, rhs, M=lambda r: dinv * r, rtol=rtol,
                restart=GMRES_RESTART, maxiter=maxiter)
    true = float(torch.linalg.norm(rhs - A(res.x))
                 / torch.linalg.norm(rhs))
    vals = unpermute_columns(sys_t, res.x[None, :])[0]
    return _finish(sys_t, vals, {
        "iters": int(res.iters), "resnorm": float(res.resnorm),
        "converged": bool(res.converged), "method": "gmres",
        "rel_resnorm": true})


def pure_diffusion_solve(mesh: MeshData, device, D=1.0, mu=1.0,
                         element="P2", rtol=1e-13,
                         solver_options=None, coarse_mesh=None) -> Function:
    """The pure-diffusion concentration on ``device``: a Function whose
    values are an f64 tensor there (FunctionSpace numbering).

    ``mu``: a number or a vectorised callable mu(x) (clamped at 0 at the
    quadrature points, as the reference's variable-mu solver does).
    ``solver_options``: ``solve_sweep``'s configuration keywords and
    ``coarse_inverse`` (as the studies take them); None is the default
    configuration.  ``coarse_mesh``: the two-level preconditioner's coarse
    mesh (``simulation.get_coarse_mesh``), used where no multigrid
    hierarchy is built (h >= 0.08).  ``c.solver_info``: iters,
    resnorm, converged (the true f64 residual of the returned c met
    rtol), rel_resnorm, passes, multilevel, twolevel."""
    return _transport_solve(mesh, device, D, mu, element, rtol,
                            solver_options=solver_options,
                            coarse_mesh=coarse_mesh)

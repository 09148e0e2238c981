"""Stokes saddle-point solver: flexible CG on the pressure Schur complement
(Uzawa), matrix-free (counterpart of ``solvers/stokes.py``).

The saddle system [[A, B^T], [B, 0]] (A the vector Laplacian with the
velocity Dirichlet conditions, B = -div) reduces to the pressure Schur
complement S = B A^-1 B^T:

    S p = B u0,   u0 = A^-1 f   (the boundary values folded into A-solves)

The outer CG on S runs on the host (tens of iterations, one inner solve
each; Polak-Ribiere beta, restarted by steepest descent on a
non-positive curvature, since the inner solves are inexact), preconditioned
by the lumped pressure mass.  The inner A-solves are ``batched_cg`` on
(n, 1) columns, Jacobi preconditioned: in f64, or (``precision="mixed"``)
f32 CG passes at inner rtol 1e-4 inside f64 refinement to max(inner_rtol,
1e-9).  The JAX package's chunk schedule is not ported (``batched_cg``
here stops at the iteration where the column converges).

With the do-nothing outlet the pressure level is fixed by the weak form
itself; no pin is applied.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .batched import batched_cg

__all__ = ["stokes_schur_cg", "StokesResult"]


class StokesResult(NamedTuple):
    u: torch.Tensor
    p: torch.Tensor
    outer_iters: int
    inner_iters: int
    resnorm: float
    converged: bool


def _col(x):
    return x[:, None]


def stokes_schur_cg(A_apply: Callable, B, bc, f=None,
                    Mp_inv: Callable = None, A_diag=None,
                    A_apply32: Optional[Callable] = None,
                    inner_rtol=1e-12, inner_maxiter=6000,
                    outer_rtol=1e-11, outer_maxiter=300,
                    precision="f64") -> StokesResult:
    """Solve the constrained Stokes saddle system.

    A_apply: the unconstrained velocity-block operator on (n, 1) f64
    columns; A_apply32: the same in f32 (needed by ``precision="mixed"``);
    B: the divergence (``apply`` velocity -> pressure, ``apply_t`` its
    transpose, both in the argument's dtype); bc: the velocity Dirichlet
    data (``free``, ``values``); Mp_inv: the pressure preconditioner;
    A_diag: A's diagonal (Jacobi for the inner solves)."""
    if precision not in ("f64", "mixed"):
        raise ValueError(f"unknown precision {precision!r}")
    mixed = precision == "mixed"
    if mixed and A_apply32 is None:
        raise ValueError("precision='mixed' needs A_apply32")
    g = torch.as_tensor(np.asarray(bc.values), dtype=torch.float64)
    dev = A_diag.device if A_diag is not None else g.device
    g = g.to(dev)
    free = torch.as_tensor(np.asarray(bc.free), device=dev)
    if f is None:
        f = torch.zeros_like(g)
    if Mp_inv is None:
        Mp_inv = lambda r: r                                   # noqa: E731

    dinv = None
    if A_diag is not None:
        d = torch.where(free & (A_diag != 0), A_diag, 1.0)
        dinv = torch.where(free, 1.0 / d, 1.0)[:, None]
    freeC = free[:, None]

    def A_bc(X):
        Y = A_apply(torch.where(freeC, X, 0.0))
        return torch.where(freeC, Y, X)

    def A_bc32(X):
        Y = A_apply32(torch.where(freeC, X, 0.0))
        return torch.where(freeC, Y, X)

    dinv32 = None if dinv is None else dinv.float()
    inner_count = 0

    def solve_A(rhs_col, x0_col):
        """A^-1 rhs on the free dofs (rhs, x0 (n, 1) with the boundary
        values in their constrained rows)."""
        nonlocal inner_count
        if not mixed:
            res = batched_cg(A_bc, rhs_col, X0=x0_col,
                             M=None if dinv is None else (lambda R: dinv * R),
                             rtol=inner_rtol, maxiter=inner_maxiter)
            inner_count += int(res.iters.max())
            return res.X
        # f32 inner passes inside f64 refinement; the outer Schur CG
        # tolerates an inner floor of 1e-9
        X = x0_col
        bnorm = float(torch.linalg.norm(rhs_col))
        target = max(inner_rtol, 1e-9)
        for _ in range(6):
            R = rhs_col - A_bc(X)
            if float(torch.linalg.norm(R)) <= target * max(bnorm, 1e-300):
                break
            res = batched_cg(A_bc32, R.float(),
                             M=None if dinv32 is None
                             else (lambda R32: dinv32 * R32),
                             rtol=1e-4, maxiter=inner_maxiter)
            inner_count += int(res.iters.max())
            X = X + res.X.to(X.dtype)
        return X

    def Bt_rhs(d):
        return torch.where(free, B.apply_t(d), 0.0)[:, None]

    def apply_B(w):
        return B.apply(w[:, 0])

    def update(p, r, d, Sd, rz):
        dSd = torch.dot(d, Sd)
        alpha = torch.where(dSd != 0, rz / torch.where(dSd != 0, dSd, 1.0),
                            0.0)
        p2 = p + alpha * d
        r2 = r - alpha * Sd
        z2 = Mp_inv(r2)
        rz_new = torch.dot(r2, z2)
        beta = torch.clamp(torch.dot(r2 - r, z2)
                           / torch.where(rz != 0, rz, 1.0), min=0.0)
        d2 = z2 + beta * d
        return p2, r2, z2, d2, rz_new, float(torch.linalg.norm(r2)), \
            float(dSd)

    # u0 = A^-1 f with the boundary values g
    rhs0 = torch.where(free, f - A_apply(_col(g))[:, 0], g)[:, None]
    u0 = solve_A(rhs0, _col(g))
    b_p = apply_B(u0)
    tol = outer_rtol * float(torch.linalg.norm(b_p))

    p = torch.zeros_like(b_p)
    r = b_p
    z = Mp_inv(r)
    d = z
    rz = torch.dot(r, z)
    w_prev = torch.zeros_like(u0)
    k = 0
    rn = float(torch.linalg.norm(r))
    while rn > tol and k < outer_maxiter:
        w = solve_A(Bt_rhs(d), w_prev)
        w_prev = w
        p2, r2, z2, d2, rz_new, rn_new, dSd = update(p, r, d, apply_B(w), rz)
        if not np.isfinite(dSd) or dSd <= 0.0:
            # conjugacy lost to the inexact inner solves: steepest descent
            d = z
            w = solve_A(Bt_rhs(d), w_prev)
            w_prev = w
            p2, r2, z2, d2, rz_new, rn_new, dSd = update(
                p, r, d, apply_B(w), rz)
            if not np.isfinite(dSd) or dSd <= 0.0:
                break
        p, r, z, d, rz, rn = p2, r2, z2, d2, rz_new, rn_new
        k += 1

    # the velocity of the final pressure: u = A^-1 (f - B^T p), values g
    rhs_u = torch.where(free, f - A_apply(_col(g))[:, 0] - B.apply_t(p),
                        g)[:, None]
    u = solve_A(rhs_u, u0)
    return StokesResult(u=u[:, 0], p=p, outer_iters=k,
                        inner_iters=inner_count, resnorm=rn,
                        converged=rn <= tol)

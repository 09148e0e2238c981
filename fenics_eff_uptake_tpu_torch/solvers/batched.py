"""Batched (multi right-hand-side) Krylov solvers in the batch-minor
``(n, B)`` layout, in one dtype (counterpart of ``solvers/batched.py``).

``batched_cg`` and ``batched_bicgstab`` advance all B columns together; a
column whose residual norm is at or below its tolerance is frozen by its
``active`` mask (its step lengths are zero, its direction is kept), so the
iterates of a converged column no longer move and every column's result is
what a solve of that column alone would give.  The iteration bodies are the
JAX package's, term for term, with its breakdown guards.  They run in the
dtype of the right-hand side: f64 for ``solve_sweep(precision="f64")``,
f32 for ``precision="f32"``.

The JAX package splits the loop into fixed-size compiled chunks with an
escalating schedule, a workaround for its runtime's cap on the length of a
device program, and so counts a column's iterations in whole chunks.  Here
the loop tests convergence on the host once per iteration (one device sync
each) and stops when no column is active; ``iters`` counts the iterations
each column was active for, which is what the JAX loop gives with chunks
of one iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["batched_cg", "batched_bicgstab", "BatchedResult"]


class BatchedResult(NamedTuple):
    X: torch.Tensor          # (n, B)
    iters: np.ndarray        # (B,) iterations each column was active for
    resnorm: np.ndarray      # (B,) recurrence residual norms at the end
    converged: np.ndarray    # (B,) bool


def _colnorm(R):
    return torch.sqrt(torch.sum(R * R, dim=0))


def _identity(X):
    return X


def _start(A, B_rhs, X0, rtol, atol):
    X = torch.zeros_like(B_rhs) if X0 is None else X0
    tol = torch.clamp(rtol * _colnorm(B_rhs), min=atol)
    return X, B_rhs - A(X), tol


def _result(X, R, tol, cit):
    rn = _colnorm(R)
    return BatchedResult(X=X, iters=cit.cpu().numpy(),
                         resnorm=rn.cpu().numpy(),
                         converged=(rn <= tol).cpu().numpy())


def batched_cg(A: Callable, B_rhs, M: Optional[Callable] = None, X0=None,
               rtol=1e-12, atol=0.0, maxiter=20000) -> BatchedResult:
    """Preconditioned CG on (n, B) right-hand sides; A and M map (n, B) to
    (n, B) in B_rhs's dtype (M symmetric positive definite; None: the
    identity)."""
    M = _identity if M is None else M
    X, R, tol = _start(A, B_rhs, X0, rtol, atol)
    Z = M(R)
    P = Z
    rz = torch.sum(R * Z, dim=0)
    cit = torch.zeros(B_rhs.shape[1], dtype=torch.int64,
                      device=B_rhs.device)
    for _ in range(maxiter):
        active = _colnorm(R) > tol
        if not bool(active.any()):
            break
        AP = A(P)
        pAp = torch.sum(P * AP, dim=0)
        alpha = torch.where(active & (pAp != 0),
                            rz / torch.where(pAp != 0, pAp, 1.0), 0.0)
        X = X + alpha * P
        R = R - alpha * AP
        Z = M(R)
        rz_new = torch.sum(R * Z, dim=0)
        beta = torch.where(active & (rz != 0),
                           rz_new / torch.where(rz != 0, rz, 1.0), 0.0)
        P = torch.where(active, Z + beta * P, P)
        rz = rz_new
        cit = cit + active
    return _result(X, R, tol, cit)


def batched_bicgstab(A: Callable, B_rhs, M: Optional[Callable] = None,
                     X0=None, rtol=1e-12, atol=0.0,
                     maxiter=20000) -> BatchedResult:
    """Right-preconditioned BiCGStab on (n, B) right-hand sides; A and M as
    in :func:`batched_cg` (M need not be symmetric)."""
    M = _identity if M is None else M
    X, R, tol = _start(A, B_rhs, X0, rtol, atol)
    Rhat = R
    B = B_rhs.shape[1]
    rho = alpha = omega = torch.ones(B, dtype=B_rhs.dtype,
                                     device=B_rhs.device)
    P = torch.zeros_like(B_rhs)
    V = torch.zeros_like(B_rhs)
    cit = torch.zeros(B, dtype=torch.int64, device=B_rhs.device)
    for _ in range(maxiter):
        active = _colnorm(R) > tol
        if not bool(active.any()):
            break
        rho_new = torch.sum(Rhat * R, dim=0)
        beta = torch.where(
            active,
            (rho_new / torch.where(rho != 0, rho, 1.0))
            * (alpha / torch.where(omega != 0, omega, 1.0)), 0.0)
        P = torch.where(active, R + beta * (P - omega * V), P)
        Phat = M(P)
        V = A(Phat)
        denom = torch.sum(Rhat * V, dim=0)
        alpha = torch.where(active & (denom != 0),
                            rho_new / torch.where(denom != 0, denom, 1.0),
                            0.0)
        S = R - alpha * V
        Shat = M(S)
        T = A(Shat)
        tt = torch.sum(T * T, dim=0)
        omega = torch.where(active & (tt != 0),
                            torch.sum(T * S, dim=0)
                            / torch.where(tt != 0, tt, 1.0), 0.0)
        X = X + alpha * Phat + omega * Shat
        R = torch.where(active, S - omega * T, R)
        rho = rho_new
        cit = cit + active
    return _result(X, R, tol, cit)

"""Batched (multi right-hand-side) Krylov solvers in the batch-minor
``(n, B)`` layout, in one dtype (counterpart of ``solvers/batched.py``).

The port's one Krylov core.  ``cg_step`` and ``bicgstab_step`` advance all
B columns by one masked iteration; a column outside its ``active`` mask is
frozen (its step lengths are zero, its direction is kept), so the iterates
of a converged column no longer move and every column's result is what a
solve of that column alone would give.  The step bodies are the JAX
package's, term for term, with its breakdown guards.  ``krylov_loop``
runs a step until no column is active or ``maxiter`` is reached.  One
step and one loop serve every transport solve of the port:

* ``parallel.sweep.solve_sweep``'s mixed passes: the f32 inner CG and
  BiCGStab of the f64 defect correction, through ``krylov_loop``;
* its f64 and f32 solves and Stokes' inner A-solves (``solvers.stokes``),
  through ``batched_cg`` / ``batched_bicgstab``, which run in the dtype of
  the right-hand side;
* the sharded chunks (``parallel.sharded_solve``): ``chunk_iters`` calls
  of the step with ``active`` taken on the device, no host read between.

The JAX package splits the loop into fixed-size compiled chunks with an
escalating schedule, a workaround for its runtime's cap on the length of a
device program, and so counts a column's iterations in whole chunks.  Here
the loop tests convergence on the host once per iteration (one device sync
each) and stops when no column is active; ``iters`` counts the iterations
each column was active for, which is what the JAX loop gives with chunks
of one iteration.  The host reads go through ``utils.profiling.host_read``
(counted in ``host_syncs``) and each iteration counts in ``krylov_steps``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils import profiling
from ..utils.profiling import host_read

__all__ = ["batched_cg", "batched_bicgstab", "BatchedResult", "CGState",
           "BiCGStabState", "cg_state", "bicgstab_state", "cg_step",
           "bicgstab_step", "krylov_loop"]


class BatchedResult(NamedTuple):
    X: torch.Tensor          # (n, B)
    iters: np.ndarray        # (B,) iterations each column was active for
    resnorm: np.ndarray      # (B,) recurrence residual norms at the end
    converged: np.ndarray    # (B,) bool


class CGState(NamedTuple):
    X: torch.Tensor          # (n, B) iterate
    R: torch.Tensor          # (n, B) recurrence residual
    Z: torch.Tensor          # M(R)
    P: torch.Tensor          # search direction
    rz: torch.Tensor         # (B,) sum(R * Z)


class BiCGStabState(NamedTuple):
    X: torch.Tensor          # (n, B) iterate
    R: torch.Tensor          # (n, B) recurrence residual
    Rhat: torch.Tensor       # the shadow residual: R at the start
    P: torch.Tensor
    V: torch.Tensor          # A(M(P))
    rho: torch.Tensor        # (B,)
    alpha: torch.Tensor      # (B,)
    omega: torch.Tensor      # (B,)


def _colnorm(R):
    return torch.sqrt(torch.sum(R * R, dim=0))


def _identity(X):
    return X


def cg_state(M, X, R) -> CGState:
    """The CG state at iterate X with residual R."""
    Z = M(R)
    return CGState(X=X, R=R, Z=Z, P=Z, rz=torch.sum(R * Z, dim=0))


def bicgstab_state(M, X, R) -> BiCGStabState:
    """The BiCGStab state at iterate X with residual R (M is not used:
    the signature is ``cg_state``'s, so a driver takes either method)."""
    one = torch.ones(R.shape[1], dtype=R.dtype, device=R.device)
    return BiCGStabState(X=X, R=R, Rhat=R, P=torch.zeros_like(R),
                         V=torch.zeros_like(R), rho=one, alpha=one,
                         omega=one)


def cg_step(A: Callable, M: Callable, s: CGState, active) -> CGState:
    """One preconditioned CG iteration of the ``active`` (B,) columns."""
    X, R, Z, P, rz = s
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
    return CGState(X=X, R=R, Z=Z, P=P, rz=rz_new)


def bicgstab_step(A: Callable, M: Callable, s: BiCGStabState,
                  active) -> BiCGStabState:
    """One right-preconditioned BiCGStab iteration of the ``active`` (B,)
    columns."""
    X, R, Rhat, P, V, rho, alpha, omega = s
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
                        rho_new / torch.where(denom != 0, denom, 1.0), 0.0)
    S = R - alpha * V
    Shat = M(S)
    T = A(Shat)
    tt = torch.sum(T * T, dim=0)
    omega = torch.where(active & (tt != 0),
                        torch.sum(T * S, dim=0)
                        / torch.where(tt != 0, tt, 1.0), 0.0)
    X = X + alpha * Phat + omega * Shat
    R = torch.where(active, S - omega * T, R)
    return BiCGStabState(X=X, R=R, Rhat=Rhat, P=P, V=V, rho=rho_new,
                         alpha=alpha, omega=omega)


def krylov_loop(step: Callable, A: Callable, M: Callable, state, tol,
                maxiter: int):
    """``step`` (``cg_step`` or ``bicgstab_step``) from ``state`` while
    some column's residual norm is above its ``tol`` (B,), at most
    ``maxiter`` times; one host read of the active mask per iteration.

    Returns (the last state, (B,) int64 iterations each column was active
    for, on the device)."""
    cit = torch.zeros(state.R.shape[1], dtype=torch.int64,
                      device=state.R.device)
    for _ in range(maxiter):
        active = _colnorm(state.R) > tol
        if not bool(host_read(active.any())):
            break
        profiling.krylov_steps += 1
        state = step(A, M, state, active)
        cit = cit + active
    return state, cit


def _solve(step, start, A, B_rhs, M, X0, rtol, atol, maxiter):
    M = _identity if M is None else M
    X = torch.zeros_like(B_rhs) if X0 is None else X0
    tol = torch.clamp(rtol * _colnorm(B_rhs), min=atol)
    state, cit = krylov_loop(step, A, M, start(M, X, B_rhs - A(X)), tol,
                             maxiter)
    rn = _colnorm(state.R)
    return BatchedResult(X=state.X, iters=host_read(cit),
                         resnorm=host_read(rn),
                         converged=host_read(rn <= tol))


def batched_cg(A: Callable, B_rhs, M: Optional[Callable] = None, X0=None,
               rtol=1e-12, atol=0.0, maxiter=20000) -> BatchedResult:
    """Preconditioned CG on (n, B) right-hand sides; A and M map (n, B) to
    (n, B) in B_rhs's dtype (M symmetric positive definite; None: the
    identity)."""
    return _solve(cg_step, cg_state, A, B_rhs, M, X0, rtol, atol, maxiter)


def batched_bicgstab(A: Callable, B_rhs, M: Optional[Callable] = None,
                     X0=None, rtol=1e-12, atol=0.0,
                     maxiter=20000) -> BatchedResult:
    """Right-preconditioned BiCGStab on (n, B) right-hand sides; A and M as
    in :func:`batched_cg` (M need not be symmetric)."""
    return _solve(bicgstab_step, bicgstab_state, A, B_rhs, M, X0, rtol,
                  atol, maxiter)

"""Preconditioned conjugate gradients for one system (counterpart of
``solvers/cg.py``).

The recurrence, breakdown guards and stopping test are the JAX package's:
stop when ||r|| <= max(rtol ||b||, atol) or after ``maxiter`` steps.  The
JAX loop is a ``lax.while_loop`` on the device; here the host tests the
norm once per iteration (one device sync each).  Vectors are 1-D tensors
in any floating dtype, on any device; the operator and preconditioner are
callables on them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["cg", "CGResult", "jacobi_preconditioner"]


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: float
    converged: bool


def jacobi_preconditioner(diag, free=None):
    """M^-1 = 1 / diag; identity on constrained dofs (``free`` False) and
    on zero diagonal entries."""
    diag = torch.as_tensor(diag)
    d = torch.where(diag.abs() > 0, diag, torch.ones_like(diag))
    if free is not None:
        d = torch.where(torch.as_tensor(free, device=d.device), d, 1.0)
    inv = 1.0 / d

    def apply(r):
        return inv * r

    return apply


def _identity(r):
    return r


def cg(A: Callable, b, x0=None, M: Optional[Callable] = None,
       rtol=1e-13, atol=0.0, maxiter=20000) -> CGResult:
    M = _identity if M is None else M
    x = torch.zeros_like(b) if x0 is None else x0
    tol = max(rtol * float(torch.linalg.norm(b)), atol)
    r = b - A(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    k = 0
    rn = float(torch.linalg.norm(r))
    while rn > tol and k < maxiter:
        Ap = A(p)
        pAp = torch.dot(p, Ap)
        alpha = rz / torch.where(pAp != 0, pAp, 1.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / torch.where(rz != 0, rz, 1.0)
        p = z + beta * p
        rz = rz_new
        k += 1
        rn = float(torch.linalg.norm(r))
    return CGResult(x=x, iters=k, resnorm=rn, converged=rn <= tol)

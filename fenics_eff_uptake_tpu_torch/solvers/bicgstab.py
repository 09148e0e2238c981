"""Preconditioned BiCGStab for one nonsymmetric system (counterpart of
``solvers/bicgstab.py``).

The recurrence, breakdown guards and stopping test are the JAX package's
(right preconditioning, shadow residual r0); the host tests the residual
norm once per iteration where the JAX loop runs on the device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["bicgstab", "BiCGStabResult"]


class BiCGStabResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: float
    converged: bool


def _identity(r):
    return r


def _guard(v):
    return torch.where(v != 0, v, 1.0)


def bicgstab(A: Callable, b, x0=None, M: Optional[Callable] = None,
             rtol=1e-13, atol=0.0, maxiter=20000) -> BiCGStabResult:
    M = _identity if M is None else M
    x = torch.zeros_like(b) if x0 is None else x0
    tol = max(rtol * float(torch.linalg.norm(b)), atol)
    r = b - A(x)
    rhat = r
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    k = 0
    rn = float(torch.linalg.norm(r))
    while rn > tol and k < maxiter:
        rho_new = torch.dot(rhat, r)
        beta = (rho_new / _guard(rho)) * (alpha / _guard(omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        alpha = rho_new / _guard(torch.dot(rhat, v))
        s = r - alpha * v
        shat = M(s)
        t = A(shat)
        omega = torch.dot(t, s) / _guard(torch.dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
        rn = float(torch.linalg.norm(r))
    return BiCGStabResult(x=x, iters=k, resnorm=rn, converged=rn <= tol)

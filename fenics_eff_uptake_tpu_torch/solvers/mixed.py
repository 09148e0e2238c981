"""Mixed-precision refinement: f32 inner Krylov solves inside f64
iterative refinement (counterpart of ``solvers/mixed.py``).

    repeat:  r = b - A x          (f64 operator)
             d = solve(A, r)      (f32 preconditioned CG or BiCGStab)
             x = x + d            (f64 accumulate)

until ||b - A x|| <= rtol ||b|| or ``max_refinements`` sweeps, from
x0 = 0, as the JAX package's ``refined_solve`` (its nested while loops run
here as host loops).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .bicgstab import bicgstab
from .cg import cg

__all__ = ["refined_solve", "RefinedResult"]


class RefinedResult(NamedTuple):
    x: torch.Tensor
    refinements: int
    inner_iters: int
    resnorm: float
    converged: bool


def refined_solve(A64: Callable, A32: Callable, b64, M32: Callable = None,
                  rtol=1e-12, inner_rtol=1e-4, inner_maxiter=20000,
                  max_refinements=12, nonsymmetric=False) -> RefinedResult:
    """Solve A x = b to f64 accuracy.  A64: the f64 operator; A32: the same
    operator in f32; M32: an f32 preconditioner; b64 f64."""
    inner = bicgstab if nonsymmetric else cg
    tol = rtol * float(torch.linalg.norm(b64))
    x = torch.zeros_like(b64)
    k = it_total = 0
    rn = float(torch.linalg.norm(b64))
    while rn > tol and k < max_refinements:
        r = b64 - A64(x)
        res = inner(A32, r.float(), M=M32, rtol=inner_rtol,
                    maxiter=inner_maxiter)
        x = x + res.x.to(b64.dtype)
        rn = float(torch.linalg.norm(b64 - A64(x)))
        k += 1
        it_total += res.iters
    return RefinedResult(x=x, refinements=k, inner_iters=it_total,
                         resnorm=rn, converged=rn <= tol)

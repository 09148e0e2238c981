"""Left-preconditioned restarted GMRES(m) (counterpart of
``solvers/gmres.py``).

The robust choice for strongly nonsymmetric systems (the high-Pe
transport solve, ``models/diffusion.py``): the Krylov vectors stay on the
device, one operator and one preconditioner apply per Arnoldi step; the
Hessenberg matrix, its Givens rotations and the triangular solve are small
host f64 numpy, and the modified Gram-Schmidt coefficients are read to the
host one by one, in the JAX package's order.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["gmres", "GMRESResult"]


class GMRESResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: float
    converged: bool


def _identity(r):
    return r


def gmres(A: Callable, b, x0=None, M: Optional[Callable] = None,
          rtol=1e-12, atol=0.0, restart=50, maxiter=2000) -> GMRESResult:
    """Solve M A x = M b from ``x0`` (default 0); stop when the
    preconditioned residual norm is at most max(rtol ||M b||, atol).
    ``iters`` counts Arnoldi steps over all restarts."""
    M = _identity if M is None else M
    x = torch.zeros_like(b) if x0 is None else x0
    tol = max(rtol * float(torch.linalg.norm(M(b))), atol)
    total = 0
    rn = np.inf
    while total < maxiter:
        r = M(b - A(x))
        rn = float(torch.linalg.norm(r))
        if rn <= tol:
            return GMRESResult(x=x, iters=total, resnorm=rn, converged=True)
        m = min(restart, maxiter - total)
        V = [r / rn]
        H = np.zeros((m + 1, m))
        g = np.zeros(m + 1)
        g[0] = rn
        cs = np.zeros(m)
        sn = np.zeros(m)
        k_used = 0
        for k in range(m):
            w = M(A(V[k]))
            for i in range(k + 1):          # modified Gram-Schmidt
                hik = float(torch.dot(V[i], w))
                H[i, k] = hik
                w = w - hik * V[i]
            hkk = float(torch.linalg.norm(w))
            H[k + 1, k] = hkk
            for i in range(k):              # the previous rotations
                t = cs[i] * H[i, k] + sn[i] * H[i + 1, k]
                H[i + 1, k] = -sn[i] * H[i, k] + cs[i] * H[i + 1, k]
                H[i, k] = t
            denom = np.hypot(H[k, k], H[k + 1, k])
            if denom == 0:
                k_used = k
                break
            cs[k] = H[k, k] / denom
            sn[k] = H[k + 1, k] / denom
            H[k, k] = denom
            H[k + 1, k] = 0.0
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            k_used = k + 1
            total += 1
            if hkk == 0.0 or abs(g[k + 1]) <= tol:
                break
            V.append(w / hkk)
        kk = k_used
        if kk > 0:
            y = np.linalg.solve(H[:kk, :kk], g[:kk])
            dx = sum(float(y[i]) * V[i] for i in range(kk))
            x = x + dx
        rn = abs(float(g[kk])) if kk < len(g) else rn
        if rn <= tol:
            break
    r = M(b - A(x))
    rn = float(torch.linalg.norm(r))
    return GMRESResult(x=x, iters=total, resnorm=rn, converged=rn <= tol)

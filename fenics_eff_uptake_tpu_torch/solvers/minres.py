"""Chunked preconditioned MINRES over tuples of tensors (counterpart of
``solvers/minres.py``).

For the Stokes saddle system [[A, B^T], [B, 0]] with a symmetric positive
definite block preconditioner; vectors are tuples (here (U (ns, 2)
scalar-layout velocity, p (np,))), so the velocity block runs through the
batch-minor scalar kernels with the two components as B = 2 columns.

The iteration is ESW Algorithm 6.1, as in the JAX package:

* inner products are taken in f64 even for f32 vectors, and the recurrence
  scalars are f64 0-d tensors on the vectors' device;
* every update is masked by ``active = |eta| > tol``, so the state freezes
  once converged and the masked counter is the true iteration count;
* the host reads |eta| once per chunk of ``chunk_iters`` steps (the JAX
  chunked dispatch): one device sync per chunk, not per step.

Its host reads go through ``utils.profiling.stokes_read`` (counted in
``stokes_host_syncs``) and its iterations count in ``minres_steps``: the
solver serves the Stokes saddle system only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling
from ..utils.profiling import stokes_read

__all__ = ["MinresResult", "minres_tree"]


class MinresResult(NamedTuple):
    x: tuple
    iters: int              # active (unmasked) iterations
    resnorm: float          # preconditioned residual norm estimate |eta|
    converged: bool


def _dot(a, b):
    return sum(torch.sum(x.double() * y.double()) for x, y in zip(a, b))


def _axpy(alpha, x, y):
    """alpha * x + y, alpha cast to each leaf's dtype."""
    return tuple(alpha.to(xi.dtype) * xi + yi for xi, yi in zip(x, y))


def _scale(alpha, x):
    return tuple(alpha.to(xi.dtype) * xi for xi in x)


def _sel(active, new, old):
    return tuple(torch.where(active, n, o) for n, o in zip(new, old))


def _where0(cond, num, den):
    """num / den where cond, else 0 (den replaced by 1 off cond)."""
    return torch.where(cond, num / torch.where(cond, den, 1.0), 0.0)


def minres_tree(A, b, M, rtol=1e-10, maxiter=2000,
                chunk_iters=80) -> MinresResult:
    """Preconditioned MINRES from x0 = 0; A symmetric, M SPD, both
    callables on tuples of tensors."""
    dev = b[0].device
    x = tuple(torch.zeros_like(t) for t in b)
    v = _axpy(torch.tensor(-1.0, dtype=torch.float64, device=dev), A(x), b)
    z = M(v)
    gam = torch.sqrt(torch.clamp(_dot(z, v), min=0.0))
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    one = torch.ones((), dtype=torch.float64, device=dev)
    zeros = tuple(torch.zeros_like(t) for t in b)
    v_old, w_old, w = zeros, zeros, zeros
    gam_old, eta = one, gam
    s_old = s = zero
    c_old = c = one
    it = zero
    rn = float(stokes_read(gam))
    tol = rtol * max(rn, 1e-300)

    dispatched = 0
    while dispatched < maxiter and rn > tol:
        for _ in range(chunk_iters):
            active = eta.abs() > tol
            ginv = _where0(gam != 0, one, gam)
            zh = _scale(ginv, z)
            Az = A(zh)
            delta = _dot(Az, zh)
            v_new = _axpy(-delta * ginv, v, Az)
            v_new = _axpy(-_where0(gam_old != 0, gam, gam_old), v_old, v_new)
            z_new = M(v_new)
            gam_new = torch.sqrt(torch.clamp(_dot(z_new, v_new), min=0.0))
            a0 = c * delta - c_old * s * gam
            a1 = torch.sqrt(a0 * a0 + gam_new * gam_new)
            a2 = s * delta + c_old * c * gam
            a3 = s_old * gam
            a1inv = _where0(a1 != 0, one, a1)
            c_new = a0 * a1inv
            s_new = gam_new * a1inv
            w_new = _axpy(-a3, w_old, zh)
            w_new = _axpy(-a2, w, w_new)
            w_new = _scale(a1inv, w_new)
            x_new = _axpy(c_new * eta, w_new, x)
            eta_new = -s_new * eta
            x = _sel(active, x_new, x)
            v_old, v = _sel(active, v, v_old), _sel(active, v_new, v)
            z = _sel(active, z_new, z)
            gam_old, gam = (torch.where(active, gam, gam_old),
                            torch.where(active, gam_new, gam))
            eta = torch.where(active, eta_new, eta)
            s_old, s = torch.where(active, s, s_old), torch.where(active,
                                                                   s_new, s)
            c_old, c = torch.where(active, c, c_old), torch.where(active,
                                                                   c_new, c)
            w_old, w = _sel(active, w, w_old), _sel(active, w_new, w)
            it = torch.where(active, it + 1, it)
        dispatched += chunk_iters
        rn = float(stokes_read(eta.abs()))
    iters = int(stokes_read(it))
    profiling.minres_steps += iters
    return MinresResult(x=x, iters=iters, resnorm=rn, converged=rn <= tol)

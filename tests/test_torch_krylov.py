"""The port's one Krylov core (``solvers/batched.py``) on seeded dense
(n, B) systems in f64: SPD ones for CG, nonsymmetric ones for BiCGStab.

* Every column of ``batched_cg`` / ``batched_bicgstab`` is what the
  single-vector ``cg`` / ``bicgstab`` gives on that column alone: the same
  iterations, X within 1e-12, though the columns stop at different
  iterations (the ``active`` masks freeze the converged ones).
* A column converged at the start is left bit for bit as it is.
* ``k`` calls of the step with the mask taken on the device (the sharded
  chunk) give the loop's state after ``k`` steps, bit for bit.

CPU only, no JAX; a few seconds.
"""

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu_torch.solvers.batched import (
    _colnorm, batched_bicgstab, batched_cg, bicgstab_state, bicgstab_step,
    cg_state, cg_step, krylov_loop)
from fenics_eff_uptake_tpu_torch.solvers.bicgstab import bicgstab
from fenics_eff_uptake_tpu_torch.solvers.cg import cg

N, B = 48, 4
RTOL = 1e-10
METHODS = {"cg": (batched_cg, cg, cg_step, cg_state),
           "bicgstab": (batched_bicgstab, bicgstab, bicgstab_step,
                        bicgstab_state)}


def _system(method, seed):
    """(A, rhs, X0): A SPD with eigenvalues 1..10 for CG, nonsymmetric
    with a dominant diagonal for BiCGStab; rhs column 0 in the span of
    three eigenvectors (CG reaches it in three steps), the rest random."""
    g = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(g.standard_normal((N, N)))
    lam = np.logspace(0.0, 1.0, N)
    if method == "cg":
        A = (Q * lam) @ Q.T
        A = 0.5 * (A + A.T)
    else:
        A = np.diag(2.0 + lam / 5.0) + g.standard_normal((N, N)) / N ** 0.5
    rhs = g.standard_normal((N, B))
    rhs[:, 0] = Q[:, :3] @ g.standard_normal(3)
    X0 = g.standard_normal((N, B))
    return torch.tensor(A), torch.tensor(rhs), torch.tensor(X0)


@pytest.mark.parametrize("variant", ["plain", "jacobi", "x0"])
@pytest.mark.parametrize("method", sorted(METHODS))
def test_columns_equal_the_single_vector_solve(method, variant):
    batched, single, _, _ = METHODS[method]
    A, rhs, X0 = _system(method, seed=len(variant))
    dinv = 1.0 / torch.diagonal(A)
    M = (lambda R: dinv[:, None] * R) if variant == "jacobi" else None
    m = (lambda r: dinv * r) if variant == "jacobi" else None
    X0 = X0 if variant == "x0" else None
    res = batched(lambda X: A @ X, rhs, M=M, X0=X0, rtol=RTOL)
    assert res.converged.all()
    assert len(set(res.iters.tolist())) > 1      # the masks froze columns
    for b in range(B):
        one = single(lambda x: A @ x, rhs[:, b], M=m, rtol=RTOL,
                     x0=None if X0 is None else X0[:, b])
        assert one.converged
        assert res.iters[b] == one.iters
        assert (res.X[:, b] - one.x).abs().max() <= 1e-12
        assert res.resnorm[b] == pytest.approx(one.resnorm, rel=1e-6)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_a_column_converged_at_the_start_is_left_as_it_is(method):
    batched = METHODS[method][0]
    A, rhs, X0 = _system(method, seed=7)
    rhs[:, 1] = (A @ X0)[:, 1]          # X0's column 1 solves exactly
    res = batched(lambda X: A @ X, rhs, X0=X0, rtol=RTOL)
    assert res.converged.all() and res.iters[1] == 0
    assert res.iters.max() > 0 and res.resnorm[1] == 0.0
    assert torch.equal(res.X[:, 1], X0[:, 1])


@pytest.mark.parametrize("method", sorted(METHODS))
def test_k_steps_equal_the_loop_after_k_iterations(method):
    _, _, step, start = METHODS[method]
    A, rhs, X0 = _system(method, seed=11)
    dinv = 1.0 / torch.diagonal(A)

    def op(X):
        return A @ X

    def M(R):
        return dinv[:, None] * R

    tol = RTOL * _colnorm(rhs)
    state0 = start(M, X0, rhs - op(X0))
    k = 6
    looped, cit = krylov_loop(step, op, M, state0, tol, maxiter=k)
    chunk = state0
    for _ in range(k):
        chunk = step(op, M, chunk, _colnorm(chunk.R) > tol)
    assert int(cit.max()) == k
    for name, a, b in zip(looped._fields, looped, chunk):
        assert torch.equal(a, b), name

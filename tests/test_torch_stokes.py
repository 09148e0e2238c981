"""The port's MINRES and Stokes solve against the JAX package.

* ``minres_tree`` on a small seeded saddle system over (U (n, 2), p (m,))
  tuples, f64 and f32 vectors (f64 inner products either way): same
  iteration count, x to 1e-10 relative in f64 and 1e-5 in f32.
* ``stokes_solve_mg`` against JAX's mixed MINRES+MG in the configuration the
  JAX package runs on a TPU (``precision="mixed"``, ``pad_shapes=True``,
  banded velocity operator and banded level applies, windowed-band
  transfers, mult cycle, deflation), forced with the environment
  tests/test_banded.py uses: u to 1e-8 and p to 1e-7 absolute (both are
  solved to a true relative residual of 1e-9); equal defect passes; MINRES
  iterations within 1.  The count moves with JAX's own padding: its
  pad_shapes=True and False runs of this mesh take 128 and 127 iterations,
  because the coarsest inverse's 1e-6 mean-|diagonal| shift averages over
  the padding rows too, and the port pads to other sizes than either.
* Poiseuille flow is exact in Taylor-Hood (mirrors
  tests/test_simulation.py::test_stokes_poiseuille_exact).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu.models.stokes_flow import \
    stokes_solve_mg as j_stokes
from fenics_eff_uptake_tpu.solvers.minres import minres_tree as j_minres
from fenics_eff_uptake_tpu_torch.convert import mesh_from
from fenics_eff_uptake_tpu_torch.meshing.generator import \
    structured_rectangle
from fenics_eff_uptake_tpu_torch.models.stokes_flow import \
    stokes_solve_mg as t_stokes
from fenics_eff_uptake_tpu_torch.solvers.minres import \
    minres_tree as t_minres

torch.set_num_threads(2)

TPU_ENV = {"FEU_ML_TBAND": "1", "FEU_ML_BAND": "1", "FEU_DISK_CACHE": "0"}


def _saddle_case(dtype, n=40, m=25, seed=3):
    """K SPD (n, n) acting on both columns of U, B (m, 2n), a diagonal SPD
    block preconditioner, and a right-hand side (U, p)."""
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal((n, n))
    K = Q @ Q.T / n + np.eye(n)
    Bm = rng.standard_normal((m, 2 * n)) / np.sqrt(n)
    b = (rng.standard_normal((n, 2)), rng.standard_normal(m))
    dK = np.diag(K)
    s = np.mean(dK) / np.sum(Bm * Bm, axis=1)
    ops = tuple(np.asarray(a, dtype) for a in (K, Bm, dK, s))
    return ops, tuple(np.asarray(t, dtype) for t in b)


def _ops(K, Bm, dK, s):
    def A(x):
        U, p = x
        return (K @ U + (Bm.T @ p).reshape(U.shape),
                Bm @ U.reshape(-1))

    def M(x):
        U, p = x
        return U / dK[:, None], s * p
    return A, M


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_minres_tree_matches_jax(dtype):
    ops, b = _saddle_case(dtype)
    Aj, Mj = _ops(*(jnp.asarray(a) for a in ops))
    At, Mt = _ops(*(torch.tensor(a) for a in ops))
    ref = j_minres(Aj, tuple(jnp.asarray(t) for t in b), M=Mj, rtol=1e-6,
                   maxiter=400, chunk_iters=10)
    got = t_minres(At, tuple(torch.tensor(t) for t in b), Mt, rtol=1e-6,
                   maxiter=400, chunk_iters=10)
    assert got.converged and ref.converged
    assert got.iters == ref.iters
    tol = 1e-10 if dtype == np.float64 else 1e-5
    for g, r in zip(got.x, ref.x):
        r = np.asarray(r)
        assert float(np.abs(g.numpy() - r).max() / np.abs(r).max()) < tol


def test_stokes_mixed_matches_jax():
    mesh = generate_mesh(width=10.0, height=1.0, sulcus_depth=1.0,
                         sulcus_width=0.5, mesh_size=0.15,
                         refinement_factor=1, domain_type="sulcus")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in TPU_ENV.items():
            mp.setenv(k, v)
        mp.delenv("FEU_ML_CYCLE", raising=False)
        uj, pj = j_stokes(mesh, 1.0, rtol=1e-9, precision="mixed",
                          pad_shapes=True)
    up, pp = t_stokes(mesh_from(mesh), 1.0, "cpu")
    info = up.solver_info
    assert info["converged"] and info["rel_resnorm"] <= 1e-9
    assert info["passes"] == 2          # JAX's pass count on this mesh
    assert abs(info["outer_iters"] - uj.solver_info["outer_iters"]) <= 1
    assert float(np.abs(up.values - np.asarray(uj.values)).max()) < 1e-8
    assert float(np.abs(pp.values - np.asarray(pj.values)).max()) < 1e-7


def test_stokes_poiseuille_exact_port():
    md = structured_rectangle(2.0, 1.0, 10, 5)
    u, p = t_stokes(md, 1.0, "cpu", rtol=1e-12)
    assert u.solver_info["converged"]
    xy = u.space.dof_coords
    assert np.abs(u.values[0::2] - 4 * xy[:, 1] * (1 - xy[:, 1])).max() \
        < 1e-9
    assert np.abs(u.values[1::2]).max() < 1e-9
    p_exact = 8 * (2.0 - p.space.dof_coords[:, 0])
    assert np.abs(p.values - p_exact).max() < 1e-8

"""The port's public names for the JAX package's simple-mu API against
it, on the CPU: ``parallel.sweep.build_mu_sweep_system`` /
``solve_mu_sweep`` (the cases of ``tests/test_parallel.py``) and
``solvers.multilevel.coarse_level_meshes``.

* ``solve_mu_sweep`` at the JAX package's CPU configuration (f64 Jacobi
  CG, rtol 1e-13): the same iterations per column (JAX's solve is run in
  one-iteration chunks, since in longer ones it counts whole chunks), and
  X within 1e-8 of JAX's and of the port's single solves, the tolerance of
  the existing sweep tests.
* ``coarse_level_meshes``: bit-equal to JAX's, as the mesher is.
"""

import functools

import numpy as np
import pytest
import torch

from fenics_eff_uptake_tpu.meshing.generator import \
    structured_rectangle as j_rect
from fenics_eff_uptake_tpu.parallel import sweep as jsw
from fenics_eff_uptake_tpu.solvers.multilevel import \
    coarse_level_meshes as j_coarse
from fenics_eff_uptake_tpu_torch.meshing.generator import \
    structured_rectangle
from fenics_eff_uptake_tpu_torch.models.diffusion import pure_diffusion_solve
from fenics_eff_uptake_tpu_torch.parallel.sweep import (
    MuSweepSystem, TransportSystem, build_mu_sweep_system,
    build_transport_system, solve_mu_sweep)
from fenics_eff_uptake_tpu_torch.solvers.multilevel import \
    coarse_level_meshes

torch.set_num_threads(2)

MUS = [0.1, 1.0, 10.0]


@pytest.mark.parametrize("D", [1.0, 0.5])
def test_mu_sweep_api_matches_jax(monkeypatch, D):
    monkeypatch.setattr(jsw, "solve_sweep", functools.partial(
        jsw.solve_sweep, chunk_iters=1))
    Xj, ij = jsw.solve_mu_sweep(
        jsw.build_mu_sweep_system(j_rect(2.0, 1.0, 10, 5), D=D), MUS,
        rtol=1e-13)
    sys_ = build_mu_sweep_system(structured_rectangle(2.0, 1.0, 10, 5),
                                 "cpu", D=D)
    assert sys_.mu_sweep_D == D
    X, info = solve_mu_sweep(sys_, MUS, rtol=1e-13, precision="f64")
    assert X.shape[0] == len(MUS)
    np.testing.assert_array_equal(info["iters"], np.asarray(ij["iters"]))
    assert np.abs(X.numpy() - np.asarray(Xj)).max() < 1e-8


def test_mu_sweep_matches_single_solves():
    mesh = structured_rectangle(2.0, 1.0, 10, 5)
    X, info = solve_mu_sweep(build_mu_sweep_system(mesh, "cpu", D=1.0), MUS,
                             rtol=1e-13)
    assert info["converged"].all()
    for i, mu in enumerate(MUS):
        c = pure_diffusion_solve(mesh, "cpu", D=1.0, mu=mu)
        assert np.abs(X[i].numpy() - c.as_numpy()).max() < 1e-8, mu


def test_mu_sweep_system_is_a_transport_system():
    mesh = structured_rectangle(2.0, 1.0, 10, 5)
    assert MuSweepSystem is TransportSystem
    sys_ = build_mu_sweep_system(mesh, "cpu", D=0.25)
    plain = build_transport_system(mesh, "cpu")
    # the recorded D rides on a copy: the memoised system stays as it was
    assert plain.mu_sweep_D is None and sys_.mu_sweep_D == 0.25
    assert sys_.K is plain.K


def test_coarse_level_meshes_bit_equal_to_jax():
    kw = dict(width=10.0, height=1.0, sulcus_depth=0.5, sulcus_width=0.5,
              refinement_factor=1, domain_type="sulcus")
    mine, theirs = coarse_level_meshes(kw, 0.05), j_coarse(kw, 0.05)
    assert len(mine) == len(theirs) == 2
    for m, j in zip(mine, theirs):
        np.testing.assert_array_equal(m.vertices, j.vertices)
        np.testing.assert_array_equal(m.cells, j.cells)
        np.testing.assert_array_equal(m.cell_domain, j.cell_domain)
        np.testing.assert_array_equal(m.bc_marker, j.bc_marker)

"""The port's sweep operator and system build against the JAX package.

* The operator on JAX-carried arrays (``convert.transport_system_from_arrays``)
  against JAX ``_operator_program(...)[0]``: 1e-12 relative in f64; 2e-5 in
  f32, where the K apply is the band (summation order, as
  tests/test_banded.py holds band against element path).
* The port's own ``build_transport_system`` against JAX's in the TPU
  configuration (``pad_shapes=True, band=True``): same dof ordering, same
  Dirichlet data and element arrays on true dofs, and bands that apply the
  same operator.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu.parallel import sweep as jsw
from fenics_eff_uptake_tpu.solvers.multilevel import _fine_dinv
from fenics_eff_uptake_tpu_torch.convert import transport_system_from_arrays
from fenics_eff_uptake_tpu_torch.ops.banded import band_apply
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw

torch.set_num_threads(2)

KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
MUS = np.array([0.1, 0.5, 1.0, 2.0])
D = np.ones(4)


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(mesh_size=0.15, **KW)


@pytest.fixture(scope="module")
def jsys(mesh):
    return jsw.build_transport_system(mesh, element="P2", pad_shapes=True,
                                      band=True)


@pytest.fixture(scope="module")
def carried(mesh, jsys):
    return transport_system_from_arrays(jsw._system_to_arrays(jsys), mesh,
                                        "P2", "cpu")


@pytest.fixture(scope="module")
def mine(mesh):
    return tsw.build_transport_system(mesh, "cpu")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_operator_matches_jax(jsys, carried, f32):
    dt = np.float32 if f32 else np.float64
    X = np.random.default_rng(0).standard_normal((jsys.ndofs, 4)).astype(dt)
    A_fn = jsw._operator_program(jsw.sys_struct_key(jsys))[0]
    a = jsw.operator_args(jsys, jnp.asarray(D), jnp.asarray(MUS), None,
                          f32=f32)
    ref = np.asarray(A_fn(a, jnp.asarray(X)))
    got = tsw.apply_operator(tsw.operator_args(carried, D, MUS, f32=f32),
                             torch.as_tensor(X)).numpy()
    assert got.dtype == dt
    assert _rel(got, ref) < (2e-5 if f32 else 1e-12)


def test_rhs_and_dinv_match_jax(jsys, carried):
    B = len(MUS)
    _, rhs_fn, _, _ = jsw._operator_program(jsw.sys_struct_key(jsys))
    a = jsw.operator_args(jsys, jnp.asarray(D), jnp.asarray(MUS), None,
                          f32=False)
    G = jnp.tile(jsys.bc_values[:, None], (1, B))
    ref = np.asarray(rhs_fn(a, G))
    Gt = carried.bc_values[:, None].expand(-1, B).contiguous()
    got = tsw.operator_rhs(tsw.operator_args(carried, D, MUS, f32=False),
                           Gt).numpy()
    assert _rel(got, ref) < 1e-12
    dref = np.asarray(_fine_dinv(jsys, jnp.asarray(D), jnp.asarray(MUS),
                                 None))
    dgot = tsw.fine_dinv(carried, D, MUS).numpy()
    assert dgot.dtype == np.float32
    assert _rel(dgot, dref) < 1e-6


def test_build_transport_system_matches_jax(jsys, mine):
    n_true = mine.space.ndofs
    assert mine.ndofs % tsw.BAND_TILE == 0 and mine.ndofs >= n_true
    np.testing.assert_array_equal(mine.perm[:n_true], jsys.perm[:n_true])
    np.testing.assert_array_equal(mine.free.numpy()[:n_true],
                                  np.asarray(jsys.free)[:n_true])
    np.testing.assert_array_equal(mine.bc_values.numpy()[:n_true],
                                  np.asarray(jsys.bc_values)[:n_true])
    assert not mine.free.numpy()[n_true:].any()
    for blk, jblk in ((mine.K, jsys.K), (mine.R, jsys.R)):
        N = blk.A64.shape[0]
        assert _rel(blk.A64.numpy(), np.asarray(jblk.A64)[:N]) < 1e-12
        np.testing.assert_array_equal(blk.dofs.numpy(),
                                      np.asarray(jblk.dofs)[:N])
    # the bands apply the same operator on true dofs
    X = np.zeros((jsys.ndofs, 3), np.float32)
    X[:n_true] = np.random.default_rng(1).standard_normal((n_true, 3))
    Yj = band_apply(torch.as_tensor(np.asarray(jsys.Kband)),
                    torch.as_tensor(X)).numpy()
    Ym = band_apply(mine.Kband, torch.as_tensor(X[:mine.ndofs])).numpy()
    assert _rel(Ym[:n_true], Yj[:n_true]) < 1e-5


def test_unpermute_columns_matches_jax(jsys, carried):
    Xc = np.random.default_rng(2).standard_normal((3, jsys.ndofs))
    ref = np.asarray(jsw.unpermute_columns(jsys, jnp.asarray(Xc)))
    got = tsw.unpermute_columns(carried, torch.as_tensor(Xc)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_jacobi_sweep_matches_jax(jsys, mine):
    """Without a hierarchy the port preconditions with Jacobi inside the
    same mixed solve; it converges to the JAX solution (1e-8, the bound
    tests/test_banded.py holds two JAX configurations to)."""
    Xj, _ = jsw.solve_sweep(jsys, D, mu_values=MUS, rtol=1e-11,
                            precision="mixed")
    Xm, info = tsw.solve_sweep(mine, D, MUS, rtol=1e-11)
    assert float(np.abs(Xm.numpy() - np.asarray(Xj)).max()) < 1e-8
    assert (info["rel_resnorm"] <= 1e-11).all()

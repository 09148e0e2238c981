"""The port's element assembly against the JAX package's, in float64.

Same mesh, same quadrature, same formulas: entity matrices agree to 1e-12
relative (only the einsum contraction order differs), dof maps and
Dirichlet data exactly.  The JAX mesh and spaces reach the port through
``convert.mesh_from`` / ``convert.space_from``.  The advection band (scattered on the stiffness
band's plan) reproduces the assembled nonsymmetric operator."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from fenics_eff_uptake_tpu.fem import assembly as jasm
from fenics_eff_uptake_tpu.fem.space import FunctionSpace
from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu.meshing.mesh_data import MARKERS
from fenics_eff_uptake_tpu_torch.convert import mesh_from, space_from
from fenics_eff_uptake_tpu_torch.fem import assembly as tasm
from fenics_eff_uptake_tpu_torch.fem.space import \
    FunctionSpace as TFunctionSpace
from fenics_eff_uptake_tpu_torch.ops.banded import band_apply
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw

torch.set_num_threads(2)

KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
RTOL = 1e-12


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(mesh_size=0.15, **KW)


@pytest.fixture(scope="module")
def tmesh(mesh):
    return mesh_from(mesh)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("element", ["P1", "P2"])
def test_stiffness_matches_jax(mesh, tmesh, element):
    sp = FunctionSpace(mesh, element)
    ref = jasm.stiffness_block(sp, D=1.0)
    A_e, dofs = tasm.stiffness_block(space_from(sp, tmesh), "cpu")
    assert _rel(A_e.numpy(), np.asarray(ref.A_e)) < RTOL
    np.testing.assert_array_equal(dofs, np.asarray(ref.entity_dofs))
    got = tsw._Block.build(A_e, dofs, sp.ndofs)
    np.testing.assert_array_equal(got.scatter.perm.numpy(),
                                  np.asarray(ref.scatter.perm))
    np.testing.assert_array_equal(got.scatter.ids_sorted.numpy(),
                                  np.asarray(ref.scatter.ids_sorted))
    diag = got.diagonal()
    assert _rel(diag.numpy(), np.asarray(ref.diagonal())) < RTOL


@pytest.mark.parametrize("element", ["P1", "P2"])
def test_robin_matches_jax(mesh, tmesh, element):
    sp = FunctionSpace(mesh, element)
    bottom = mesh.bc_marker == MARKERS["bottom"]
    ref = jasm.robin_facet_block(sp, bottom, mu=1.0)
    A_e, dofs = tasm.robin_facet_block(space_from(sp, tmesh), bottom, "cpu")
    assert A_e.shape == tuple(ref.A_e.shape)
    assert _rel(A_e.numpy(), np.asarray(ref.A_e)) < RTOL
    np.testing.assert_array_equal(dofs, np.asarray(ref.entity_dofs))


@pytest.mark.parametrize("element", ["P1", "P2"])
def test_bc_matches_jax(mesh, tmesh, element):
    sp = FunctionSpace(mesh, element)
    pairs = [(MARKERS["left"], 1.0), (MARKERS["right"], 0.0)]
    ref = jasm.make_bc(sp, pairs)
    got = tasm.make_bc(space_from(sp, tmesh), pairs)
    np.testing.assert_array_equal(got.free, np.asarray(ref.free))
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))
    assert (~got.free).sum() > 0


def _velocity(mesh):
    """A P2 vector field with both components nonzero (numpy, seeded)."""
    V = FunctionSpace(mesh, "P2", vs=2)
    xy = V.dof_coords
    rng = np.random.default_rng(4)
    u = np.zeros(V.ndofs)
    u[0::2] = 4.0 * xy[:, 1] * (1.0 - xy[:, 1]) + 0.1 * rng.random(len(xy))
    u[1::2] = 0.2 * np.sin(xy[:, 0]) + 0.1 * rng.random(len(xy))
    return u, V


@pytest.mark.parametrize("element", ["P1", "P2"])
def test_mass_matches_jax(mesh, tmesh, element):
    sp = FunctionSpace(mesh, element)
    ref = jasm.mass_block(sp)
    A_e, dofs = tasm.mass_block(space_from(sp, tmesh), "cpu")
    assert _rel(A_e.numpy(), np.asarray(ref.A_e)) < RTOL
    np.testing.assert_array_equal(dofs, np.asarray(ref.entity_dofs))


@pytest.mark.parametrize("element", ["P1", "P2"])
def test_advection_matches_jax(mesh, tmesh, element):
    """P2 velocity advecting a P1 (multigrid level) or P2 (fine) field."""
    u, V = _velocity(mesh)
    sp = FunctionSpace(mesh, element)
    ref = jasm.advection_block(sp, u, V)
    A_e, dofs = tasm.advection_block(space_from(sp, tmesh), u,
                                     space_from(V, tmesh), "cpu")
    assert _rel(A_e.numpy(), np.asarray(ref.A_e)) < RTOL
    np.testing.assert_array_equal(dofs, np.asarray(ref.entity_dofs))
    # nonsymmetric, as advection must be
    assert _rel(A_e.numpy(), A_e.numpy().transpose(0, 2, 1)) > 1e-3


def test_divergence_matches_jax(mesh, tmesh):
    Q = FunctionSpace(mesh, "P1")
    V = FunctionSpace(mesh, "P2", vs=2)
    ref = jasm.divergence_block(Q, V)
    B_e, rd, cd = tasm.divergence_block(space_from(Q, tmesh),
                                        space_from(V, tmesh), "cpu")
    assert B_e.shape == (mesh.num_cells, 3, 12)
    assert _rel(B_e.numpy(), np.asarray(ref.B_e)) < RTOL
    np.testing.assert_array_equal(rd, np.asarray(ref.row_dofs))
    np.testing.assert_array_equal(cd, np.asarray(ref.col_dofs))


def test_advection_band_matches_dense(mesh, tmesh):
    """The f32 Adv band of an advective system applies the assembled
    nonsymmetric operator (scipy, f64) to 1e-6 of its largest entry (f32
    band values and sums), on every true dof and in the system's order."""
    u, V = _velocity(mesh)
    sys = tsw.build_transport_system(tmesh, "cpu", u_values=u,
                                     u_space=space_from(V, tmesh))
    assert sys.Advband.shape == sys.Kband.shape
    A_e, ed = tasm.advection_block(sys.space, u, space_from(V, tmesh),
                                   "cpu")
    n = sys.space.ndofs
    nd = ed.shape[1]
    A = sps.coo_matrix((A_e.numpy().ravel(),
                        (np.repeat(ed, nd, axis=1).ravel(),
                         np.tile(ed, (1, nd)).ravel())), shape=(n, n)).tocsr()
    X = np.random.default_rng(6).standard_normal((n, 3))
    Xs = np.zeros((sys.ndofs, 3), np.float32)
    Xs[sys.iperm[:n]] = X
    Y = band_apply(sys.Advband, torch.as_tensor(Xs)).numpy()[sys.iperm[:n]]
    ref = A @ X
    assert float(np.abs(Y - ref).max() / np.abs(ref).max()) < 1e-6
    # and the f64 element block applies it exactly
    Ye = sys.Adv.apply_batched(torch.as_tensor(Xs, dtype=torch.float64))
    assert _rel(Ye.numpy()[sys.iperm[:n]], A @ Xs[sys.iperm[:n]]) < RTOL


def test_element_block_apply_matches_scipy(tmesh):
    """K + R applied through the element block equals the assembled
    sparse matrix product (f64, 1e-12 relative)."""
    mesh = tmesh
    sp = TFunctionSpace(mesh, "P2")
    bottom = mesh.bc_marker == MARKERS["bottom"]
    blocks = [tasm.stiffness_block(sp, "cpu"),
              tasm.robin_facet_block(sp, bottom, "cpu")]
    n = sp.ndofs
    rows, cols, vals = [], [], []
    for A_e, ed in blocks:
        nd = ed.shape[1]
        rows.append(np.repeat(ed, nd, axis=1).ravel())
        cols.append(np.tile(ed, (1, nd)).ravel())
        vals.append(A_e.numpy().ravel())
    A = sps.coo_matrix((np.concatenate(vals),
                        (np.concatenate(rows), np.concatenate(cols))),
                       shape=(n, n)).tocsr()
    X = np.random.default_rng(3).standard_normal((n, 4))
    Xt = torch.as_tensor(X)
    Y = sum(tsw._Block.build(A_e, ed, n).apply_batched(Xt)
            for A_e, ed in blocks).numpy()
    assert _rel(Y, A @ X) < RTOL

"""The port's element assembly against the JAX package's, in float64.

Same mesh, same quadrature, same formulas: entity matrices agree to 1e-12
relative (only the einsum contraction order differs), dof maps and
Dirichlet data exactly."""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from fenics_eff_uptake_tpu.fem import assembly as jasm
from fenics_eff_uptake_tpu.fem.space import FunctionSpace
from fenics_eff_uptake_tpu.meshing.generator import generate_mesh
from fenics_eff_uptake_tpu.meshing.mesh_data import MARKERS
from fenics_eff_uptake_tpu_torch.fem import assembly as tasm
from fenics_eff_uptake_tpu_torch.parallel import sweep as tsw

torch.set_num_threads(2)

KW = dict(width=10.0, height=1.0, sulcus_depth=0.25, sulcus_width=0.25,
          refinement_factor=1, domain_type="sulcus")
RTOL = 1e-12


@pytest.fixture(scope="module")
def mesh():
    return generate_mesh(mesh_size=0.15, **KW)


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("element", ["P1", "P2"])
def test_stiffness_matches_jax(mesh, element):
    sp = FunctionSpace(mesh, element)
    ref = jasm.stiffness_block(sp, D=1.0)
    A_e, dofs = tasm.stiffness_block(sp, "cpu")
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
def test_robin_matches_jax(mesh, element):
    sp = FunctionSpace(mesh, element)
    bottom = mesh.bc_marker == MARKERS["bottom"]
    ref = jasm.robin_facet_block(sp, bottom, mu=1.0)
    A_e, dofs = tasm.robin_facet_block(sp, bottom, "cpu")
    assert A_e.shape == tuple(ref.A_e.shape)
    assert _rel(A_e.numpy(), np.asarray(ref.A_e)) < RTOL
    np.testing.assert_array_equal(dofs, np.asarray(ref.entity_dofs))


@pytest.mark.parametrize("element", ["P1", "P2"])
def test_bc_matches_jax(mesh, element):
    sp = FunctionSpace(mesh, element)
    pairs = [(MARKERS["left"], 1.0), (MARKERS["right"], 0.0)]
    ref = jasm.make_bc(sp, pairs)
    got = tasm.make_bc(sp, pairs)
    np.testing.assert_array_equal(got.free, np.asarray(ref.free))
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))
    assert (~got.free).sum() > 0


def test_element_block_apply_matches_scipy(mesh):
    """K + R applied through the element block equals the assembled
    sparse matrix product (f64, 1e-12 relative)."""
    sp = FunctionSpace(mesh, "P2")
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

"""Batched element assembly in PyTorch (counterpart of ``fem/assembly.py``).

Each weak-form term of the no-advection sweep is a vectorised quadrature
einsum in float64 that emits per-entity dense matrices ``A_e (N, nd, nd)``
with their entity -> dof map ``(N, nd)`` (``parallel.sweep`` renumbers the
dofs and builds the operator block from the pair):

  stiffness (P2 x P2 grads)   quadrature degree 2
  Robin facet phi phi         degree 4 (1-D Gauss), unit mu

Meshes, dof maps, quadrature rules and basis tables come from the JAX
package's host modules, which never load jax.  Unlike the JAX assembly,
nothing is padded to shape buckets: those only kept TPU compile keys stable.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fenics_eff_uptake_tpu.fem.elements import (_EDGE_VERTS, _REF_VERTS,
                                                tabulate, tabulate_grad)
from fenics_eff_uptake_tpu.fem.quadrature import interval_rule, triangle_rule
from fenics_eff_uptake_tpu.fem.space import FunctionSpace

__all__ = ["cell_geometry", "stiffness_block", "robin_facet_block",
           "BCData", "make_bc"]

_F64 = torch.float64


def _t(a, device):
    return torch.as_tensor(np.asarray(a), dtype=_F64, device=device)


def cell_geometry(vertices, cells):
    """Per-cell affine map data: detJ (T,), invJT (T, 2, 2)."""
    p = vertices[cells]                               # (T, 3, 2)
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    detJ = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    inv = torch.stack([
        torch.stack([d2[:, 1], -d2[:, 0]], dim=-1),
        torch.stack([-d1[:, 1], d1[:, 0]], dim=-1),
    ], dim=1) / detJ[:, None, None]                   # inv(J), rows
    return detJ, inv.transpose(1, 2)


def _stiffness_dev(verts, cells, qw, gref):
    detJ, invJT = cell_geometry(verts, cells)
    G = torch.einsum("tab,qib->tqia", invJT, gref)
    return torch.einsum("q,tqia,tqja,t->tij", qw, G, G, detJ)


def _robin_dev(w, tabs, le, lens):
    phi_f = tabs[le]
    return torch.einsum("q,fqi,fqj,f->fij", w, phi_f, phi_f, lens)


def stiffness_block(space: FunctionSpace, device):
    """Unit stiffness K_e[i,j] = int grad(phi_i) . grad(phi_j) dx.

    Returns (A_e (T, nd, nd) f64 tensor, cell dofs (T, nd) numpy)."""
    mesh = space.mesh
    qp, qw = triangle_rule(2)
    K = _stiffness_dev(_t(mesh.vertices, device),
                       torch.as_tensor(np.asarray(mesh.cells),
                                       dtype=torch.long, device=device),
                       _t(qw, device),
                       _t(tabulate_grad(space.element, qp), device))
    return K, np.asarray(space.cell_dofs)


def _facet_data(space: FunctionSpace, facet_mask):
    """Per-selected-facet owning cells, local edge ids and endpoints."""
    mesh = space.mesh
    fs = mesh.boundary
    sel = np.flatnonzero(facet_mask)
    cells_f = fs.cell[sel]
    le = fs.local_edge[sel]
    lv = _EDGE_VERTS_ARR[le]
    ga = mesh.cells[cells_f, lv[:, 0]]
    gb = mesh.cells[cells_f, lv[:, 1]]
    return sel, cells_f, le, ga, gb


_EDGE_VERTS_ARR = np.array([_EDGE_VERTS[i] for i in range(3)])


def _edge_tables(element, t):
    """Basis values along each of the 3 local edges at params t: (3,Q,nd)."""
    tabs = []
    for le in range(3):
        a, b = _EDGE_VERTS[le]
        pts = ((1.0 - t)[:, None] * _REF_VERTS[a]
               + t[:, None] * _REF_VERTS[b])
        tabs.append(tabulate(element, pts))
    return np.stack(tabs, axis=0)


def robin_facet_block(space: FunctionSpace, facet_mask, device):
    """Unit-mu Robin R_f[i,j] = int_f phi_i phi_j ds (the sweep scales it
    by mu per column; spatially varying mu(x) is not ported yet).

    Returns (A_f (F, nd, nd) f64 tensor, owner-cell dofs (F, nd) numpy)."""
    mesh = space.mesh
    t, w = interval_rule(4)
    _, cells_f, le, ga, gb = _facet_data(space, facet_mask)
    lens = np.linalg.norm(mesh.vertices[gb] - mesh.vertices[ga], axis=1)
    R = _robin_dev(_t(w, device),
                   _t(_edge_tables(space.element, t), device),
                   torch.as_tensor(le, dtype=torch.long, device=device),
                   _t(lens, device))
    return R, np.asarray(space.cell_dofs)[cells_f]


class BCData(NamedTuple):
    free: np.ndarray        # (ndofs,) bool
    values: np.ndarray      # (ndofs,) bc value where constrained, else 0


def make_bc(space: FunctionSpace, marker_value_pairs) -> BCData:
    """Dirichlet data from (marker_id, value) pairs on the bc markers of a
    scalar space (scalar values: the transport problem's)."""
    marker = space.mesh.bc_marker
    free = np.ones(space.ndofs, dtype=bool)
    vals = np.zeros(space.ndofs)
    for marker_id, value in marker_value_pairs:
        dofs = space.boundary_scalar_dofs(marker == marker_id)
        free[dofs] = False
        vals[dofs] = float(value)
    return BCData(free=free, values=vals)

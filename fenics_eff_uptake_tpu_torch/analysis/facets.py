"""Facet quadrature tables (counterpart of ``analysis/facets.py``).

Built in host numpy, as the JAX package builds them; the batched metrics
move them to the device once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from fenics_eff_uptake_tpu.fem.elements import (_EDGE_VERTS, _REF_VERTS,
                                                tabulate, tabulate_grad)
from fenics_eff_uptake_tpu.fem.quadrature import interval_rule
from fenics_eff_uptake_tpu.fem.space import FunctionSpace

__all__ = ["FacetQuad", "build_facet_quad"]

_CYC_A = np.array([1, 2, 0])
_CYC_B = np.array([2, 0, 1])


class FacetQuad(NamedTuple):
    """Quadrature data for a set of F facets (one side), Q points each."""
    phi: np.ndarray           # (F, Q, nd) basis values
    grad: np.ndarray          # (F, Q, nd, 2) physical basis gradients
    normal: np.ndarray        # (F, 2) outward unit normal of the owner cell
    length: np.ndarray        # (F,)
    qw: np.ndarray            # (Q,)
    cell_dofs: np.ndarray     # (F, nd)


def _edge_ref_points(t):
    pts = []
    for le in range(3):
        a, b = _EDGE_VERTS[le]
        pts.append((1.0 - t)[:, None] * _REF_VERTS[a]
                   + t[:, None] * _REF_VERTS[b])
    return np.stack(pts, axis=0)


def build_facet_quad(space: FunctionSpace, cells_f, local_edges,
                     degree) -> FacetQuad:
    """Facet quadrature for facets given as (owner cell, local edge)."""
    mesh = space.mesh
    cells_f = np.asarray(cells_f, dtype=np.int64)
    le = np.asarray(local_edges, dtype=np.int64)
    t, w = interval_rule(degree)
    refpts = _edge_ref_points(t)
    tabs = np.stack([tabulate(space.element, refpts[k]) for k in range(3)])
    gtabs = np.stack([tabulate_grad(space.element, refpts[k])
                      for k in range(3)])
    phi = tabs[le]
    gref = gtabs[le]

    pv = np.asarray(mesh.vertices)[np.asarray(mesh.cells)[cells_f]]
    d1 = pv[:, 1] - pv[:, 0]
    d2 = pv[:, 2] - pv[:, 0]
    detJ = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    inv = np.stack([
        np.stack([d2[:, 1], -d2[:, 0]], axis=-1),
        np.stack([-d1[:, 1], d1[:, 0]], axis=-1),
    ], axis=1) / detJ[:, None, None]
    grad = np.einsum("fab,fqib->fqia", np.swapaxes(inv, 1, 2), gref)

    ca = mesh.cells[cells_f, _CYC_A[le]]
    cb = mesh.cells[cells_f, _CYC_B[le]]
    d = mesh.vertices[cb] - mesh.vertices[ca]
    lens = np.linalg.norm(d, axis=1)
    n = np.stack([d[:, 1], -d[:, 0]], axis=1) / np.maximum(
        lens[:, None], 1e-300)
    return FacetQuad(phi=phi, grad=grad, normal=n, length=lens,
                     qw=np.asarray(w),
                     cell_dofs=np.asarray(space.cell_dofs)[cells_f])

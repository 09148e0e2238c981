"""DOF maps for P1 / P2 scalar and vector spaces and Taylor-Hood.
(The port's copy of the JAX package's ``fem/dofmap.py``.)

Replaces dolfin dofmaps behind ``FunctionSpace(mesh, "CG", k)`` /
``VectorFunctionSpace`` / ``MixedElement`` (ref simulation.py:128-130,146).

Conventions:
  P1 dof i            = vertex i.
  P2 dofs             = [vertices (V), edges (E)]; cell_dofs(t) =
                        [v0,v1,v2, V+e(v1,v2), V+e(v0,v2), V+e(v0,v1)]
                        (edge dof k sits opposite vertex k, matching
                        fem.elements' P2 local ordering).
  Vector spaces       : interleaved components, dof = 2*scalar_dof + comp.
  Taylor-Hood (mixed) : velocity block [0, 2*N2), pressure [2*N2, 2*N2+N1).

Built host-side with NumPy once per mesh; shipped to device as int32.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["build_edges", "p1_dofmap", "p2_dofmap", "DofMap"]


@dataclass
class DofMap:
    cell_dofs: np.ndarray      # (T, ndof_local) int64
    ndofs: int
    dof_coords: np.ndarray     # (ndofs, 2) float64
    element: str               # 'P1' | 'P2'


def build_edges(cells: np.ndarray):
    """Unique edges + per-cell edge indices (edge k opposite vertex k).

    Returns (edges (E,2) with v_min < v_max, cell_edges (T,3)).
    """
    loc = np.array([[1, 2], [0, 2], [0, 1]])
    a = cells[:, loc[:, 0]]  # (T,3)
    b = cells[:, loc[:, 1]]
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    key = lo.astype(np.int64) * (1 << 32) + hi
    uniq, inv = np.unique(key, return_inverse=True)
    edges = np.stack([uniq >> 32, uniq & ((1 << 32) - 1)], axis=1)
    cell_edges = inv.reshape(cells.shape[0], 3)
    return edges.astype(np.int64), cell_edges.astype(np.int64)


def p1_dofmap(vertices, cells) -> DofMap:
    return DofMap(cell_dofs=np.asarray(cells, dtype=np.int64),
                  ndofs=len(vertices),
                  dof_coords=np.asarray(vertices, dtype=np.float64),
                  element="P1")


def p2_dofmap(vertices, cells) -> DofMap:
    V = len(vertices)
    edges, cell_edges = build_edges(cells)
    cell_dofs = np.concatenate([cells, V + cell_edges], axis=1)
    midpoints = 0.5 * (vertices[edges[:, 0]] + vertices[edges[:, 1]])
    coords = np.concatenate([vertices, midpoints], axis=0)
    return DofMap(cell_dofs=cell_dofs.astype(np.int64),
                  ndofs=V + len(edges),
                  dof_coords=coords,
                  element="P2")


def vector_cell_dofs(scalar_cell_dofs: np.ndarray):
    """Interleaved 2-component cell dofs: (T, 2*nd) [x0,y0,x1,y1,...]."""
    T, nd = scalar_cell_dofs.shape
    out = np.empty((T, 2 * nd), dtype=np.int64)
    out[:, 0::2] = 2 * scalar_cell_dofs
    out[:, 1::2] = 2 * scalar_cell_dofs + 1
    return out

"""Reference-element basis tabulation: P1, P2 (Lagrange) on triangles.
(The port's copy of the JAX package's ``fem/elements.py``.)

Replaces dolfin/FIAT tabulation behind ``FunctionSpace(mesh, "CG", k)``
(ref simulation.py:128-130,146).  Local DOF ordering follows the classic
Lagrange convention:

  P1: phi_0..phi_2 at vertices v0, v1, v2.
  P2: phi_0..phi_2 at vertices; phi_3 at edge midpoint (v1,v2),
      phi_4 at (v0,v2), phi_5 at (v0,v1)  -- i.e. edge i is opposite vertex i.

Barycentric coordinates on the reference triangle with vertices
(0,0),(1,0),(0,1):  L0 = 1-x-y, L1 = x, L2 = y.
"""

from __future__ import annotations

import numpy as np

__all__ = ["P1", "P2", "tabulate", "tabulate_grad", "facet_tabulate",
           "NDOF", "VALUE_SIZE"]

NDOF = {"P1": 3, "P2": 6}


def _bary(points):
    pts = np.atleast_2d(np.asarray(points, dtype=np.float64))
    x, y = pts[:, 0], pts[:, 1]
    return np.stack([1.0 - x - y, x, y], axis=1)  # (Q,3)


def tabulate(element: str, points):
    """Basis values at reference points; shape (Q, ndof)."""
    L = _bary(points)
    L0, L1, L2 = L[:, 0], L[:, 1], L[:, 2]
    if element == "P1":
        return np.stack([L0, L1, L2], axis=1)
    if element == "P2":
        return np.stack([
            L0 * (2 * L0 - 1), L1 * (2 * L1 - 1), L2 * (2 * L2 - 1),
            4 * L1 * L2, 4 * L0 * L2, 4 * L0 * L1,
        ], axis=1)
    raise ValueError(f"unknown element {element}")


def tabulate_grad(element: str, points):
    """Reference gradients at points; shape (Q, ndof, 2)."""
    L = _bary(points)
    L0, L1, L2 = L[:, 0], L[:, 1], L[:, 2]
    Q = L.shape[0]
    # dL0 = (-1,-1), dL1 = (1,0), dL2 = (0,1)
    if element == "P1":
        g = np.zeros((Q, 3, 2))
        g[:, 0] = [-1.0, -1.0]
        g[:, 1] = [1.0, 0.0]
        g[:, 2] = [0.0, 1.0]
        return g
    if element == "P2":
        g = np.zeros((Q, 6, 2))
        # phi_i = Li(2Li-1): grad = (4Li-1) dLi
        g[:, 0, 0] = -(4 * L0 - 1)
        g[:, 0, 1] = -(4 * L0 - 1)
        g[:, 1, 0] = (4 * L1 - 1)
        g[:, 2, 1] = (4 * L2 - 1)
        # phi_3 = 4 L1 L2
        g[:, 3, 0] = 4 * L2
        g[:, 3, 1] = 4 * L1
        # phi_4 = 4 L0 L2 : grad = 4(L2 dL0 + L0 dL2)
        g[:, 4, 0] = -4 * L2
        g[:, 4, 1] = 4 * (L0 - L2)
        # phi_5 = 4 L0 L1
        g[:, 5, 0] = 4 * (L0 - L1)
        g[:, 5, 1] = -4 * L1
        return g
    raise ValueError(f"unknown element {element}")


# Facet (edge) tabulation: local edges of the reference triangle, edge i
# opposite vertex i, parametrised t in [0,1]:
#   edge 0: v1 -> v2 : (1-t, t) in (x,y)... actually (x,y) = (1-t)*v1 + t*v2
#   edge 1: v0 -> v2
#   edge 2: v0 -> v1
_EDGE_VERTS = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
_REF_VERTS = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])


def facet_tabulate(element: str, local_edge: int, t_points):
    """Basis values along local edge at 1-D parameters t; shape (Q, ndof).

    Also returns the reference points used, shape (Q,2).
    """
    t = np.asarray(t_points, dtype=np.float64).reshape(-1, 1)
    a, b = _EDGE_VERTS[local_edge]
    pts = (1.0 - t) * _REF_VERTS[a] + t * _REF_VERTS[b]
    return tabulate(element, pts), pts


class _Element:
    def __init__(self, name):
        self.name = name
        self.ndof = NDOF[name]

    def tabulate(self, points):
        return tabulate(self.name, points)

    def tabulate_grad(self, points):
        return tabulate_grad(self.name, points)


P1 = _Element("P1")
P2 = _Element("P2")

VALUE_SIZE = {"scalar": 1, "vector": 2}

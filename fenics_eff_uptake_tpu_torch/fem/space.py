"""FunctionSpace / Function: thin array-backed equivalents of dolfin's.

The port's copy of the JAX package's ``fem/space.py``.  A Function is just
(space, values) with values a torch tensor or a numpy array; all evaluation
and assembly is vectorised.  Replaces ``Function(C)`` / ``Function(W)`` in the
reference (solvers.py:54,297; simulation.py:128-146).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .dofmap import DofMap, p1_dofmap, p2_dofmap, vector_cell_dofs

__all__ = ["FunctionSpace", "Function"]


class FunctionSpace:
    """Scalar or vector Lagrange space on a MeshData.

    vs = value size (1 scalar, 2 vector).  Vector dofs are interleaved.
    """

    def __init__(self, mesh, element: str, vs: int = 1):
        self.mesh = mesh
        self.element = element
        self.vs = vs
        if element == "P1":
            self.scalar_dofmap = p1_dofmap(mesh.vertices, mesh.cells)
        elif element == "P2":
            self.scalar_dofmap = p2_dofmap(mesh.vertices, mesh.cells)
        else:
            raise ValueError(element)
        self.ndofs_scalar = self.scalar_dofmap.ndofs
        self.ndofs = self.ndofs_scalar * vs
        if vs == 1:
            self.cell_dofs = self.scalar_dofmap.cell_dofs
        else:
            self.cell_dofs = vector_cell_dofs(self.scalar_dofmap.cell_dofs)
        self.dof_coords = self.scalar_dofmap.dof_coords  # per scalar dof

    @property
    def nd_local(self):
        return self.cell_dofs.shape[1]

    def new_function(self, values=None):
        if values is None:
            values = np.zeros(self.ndofs)
        return Function(self, values)

    def boundary_scalar_dofs(self, facet_mask):
        """Scalar dof ids lying on the given boundary facets.

        For P1: facet endpoint vertices.  For P2: endpoint vertices + the
        facet's edge-midpoint dof (cell_dofs[cell, 3+local_edge]).
        """
        mesh = self.mesh
        fs = mesh.boundary
        sel = np.flatnonzero(facet_mask)
        verts = np.unique(fs.edges[sel].ravel())
        if self.element == "P1":
            return verts
        edge_dofs = self.scalar_dofmap.cell_dofs[
            fs.cell[sel], 3 + fs.local_edge[sel]]
        return np.unique(np.concatenate([verts, edge_dofs]))


@dataclass
class Function:
    space: FunctionSpace
    values: "object"    # torch tensor or numpy array, shape (ndofs,)

    def as_numpy(self):
        v = self.values
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v)

    def min(self):
        return float(np.min(self.as_numpy()))

    def max(self):
        return float(np.max(self.as_numpy()))

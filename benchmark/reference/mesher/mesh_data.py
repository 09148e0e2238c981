"""Mesh container: vertices/cells/facets as arrays, host-built, device-ready.
(A frozen copy of the port's ``meshing/mesh_data.py``: the benchmark's reference
remakes each mesh with it, independent of the package under test.)

Replaces dolfin's ``Mesh`` + ``MeshFunction`` objects (ref mesh.py:421-453)
with plain arrays:

  vertices      (V,2) float64
  cells         (T,3) int32, CCW-oriented
  cell_domain   (T,)  int32: 1 = sulcus cavity (centroid y<=0), 2 = channel
                (ref mesh.py:449-451); rectangular meshes are all 2.
  Boundary facets carry (cell, local_edge) so facet quadrature maps into the
  owning cell's reference coordinates; interior y=0 facets carry both sides.

Marker id scheme is the reference's (mesh.py:43-47):
  left=1 right=2 top=3 bottom=4 bottom_left=5 sulcus=6 bottom_right=7
  sulcus_opening=8 y0_line=10
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

__all__ = ["MeshData", "MARKERS", "extract_facets", "orient_ccw"]

MARKERS = {
    "left": 1, "right": 2, "top": 3, "bottom": 4,
    "bottom_left": 5, "sulcus": 6, "bottom_right": 7, "sulcus_opening": 8,
    "y0_line": 10,
}

# local edge i of a triangle is opposite vertex i: edge 0=(v1,v2), 1=(v0,v2),
# 2=(v0,v1) -- must match fem.elements._EDGE_VERTS
_LOCAL_EDGES = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int64)


def orient_ccw(vertices: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """Return cells with positive (CCW) orientation."""
    v = vertices
    c = cells
    d1 = v[c[:, 1]] - v[c[:, 0]]
    d2 = v[c[:, 2]] - v[c[:, 0]]
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    flipped = c.copy()
    neg = det < 0
    flipped[neg, 1], flipped[neg, 2] = c[neg, 2], c[neg, 1]
    return flipped


@dataclass
class FacetSet:
    """A set of facets with ownership info for facet assembly.

    edges      (F,2) global vertex ids, ordered along the owning cell's CCW
               cycle so that the outward normal is rot(-90deg) of (b-a).
    cell       (F,)  owning cell index
    local_edge (F,)  local edge id (0..2) in the owning cell
    """

    edges: np.ndarray
    cell: np.ndarray
    local_edge: np.ndarray

    def __len__(self):
        return len(self.cell)


@dataclass
class InteriorFacetSet:
    """Interior facets with both adjacent cells.

    plus/minus: '+' side is the CHANNEL side (domain marker 2) for y=0 mouth
    facets, so the reference's rectangle-side DG0 trace (analysis.py:216-241)
    is simply the '+' side here.
    """

    edges: np.ndarray            # (F,2) global vertex ids
    cell_plus: np.ndarray        # (F,) channel-side cell
    local_edge_plus: np.ndarray  # (F,)
    cell_minus: np.ndarray       # (F,) cavity-side cell
    local_edge_minus: np.ndarray # (F,)

    def __len__(self):
        return len(self.cell_plus)


@dataclass
class MeshData:
    vertices: np.ndarray
    cells: np.ndarray
    domain_type: str                     # 'sulcus' | 'rectangular'
    cell_domain: np.ndarray
    boundary: FacetSet
    bc_marker: np.ndarray                # (B,) in {0,1,2,3,4}
    bottom_marker: np.ndarray            # (B,) in {0,5,6,7,8}
    y0_marker: np.ndarray                # (B,) in {0,10}
    interior_y0: Optional[InteriorFacetSet]
    geom: "object" = None                # SulcusGeometry
    info: Dict = field(default_factory=dict)

    @property
    def num_vertices(self):
        return len(self.vertices)

    @property
    def num_cells(self):
        return len(self.cells)

    def cell_sizes(self):
        """Cell diameters (longest edge), dolfin ``h`` convention."""
        v = self.vertices
        c = self.cells
        e0 = np.linalg.norm(v[c[:, 1]] - v[c[:, 2]], axis=1)
        e1 = np.linalg.norm(v[c[:, 0]] - v[c[:, 2]], axis=1)
        e2 = np.linalg.norm(v[c[:, 0]] - v[c[:, 1]], axis=1)
        return np.maximum(np.maximum(e0, e1), e2)

    def hmin(self):
        return float(self.cell_sizes().min())

    def hmax(self):
        return float(self.cell_sizes().max())

    def cell_areas(self):
        v = self.vertices
        c = self.cells
        d1 = v[c[:, 1]] - v[c[:, 0]]
        d2 = v[c[:, 2]] - v[c[:, 0]]
        return 0.5 * (d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])

    def mesh_info(self):
        return {
            "num_vertices": int(self.num_vertices),
            "num_cells": int(self.num_cells),
            "hmin": self.hmin(),
            "hmax": self.hmax(),
        }

    def interior_sulcus_opening(self) -> Optional[InteriorFacetSet]:
        """Interior-facet set for marker 8 (``dS(sulcus_opening)``).

        The reference marks ``sulcus_opening`` with strict inequalities
        ``xL + EPS < x < xR - EPS`` and no on_boundary restriction
        (ref mesh.py:425-453), so on the conforming mouth line it selects
        the *interior* y=0 facets excluding the two corner-touching ones;
        its ``dS`` measures (ref mesh.py:721-737) integrate over exactly
        that subset.  ``interior_y0`` holds all interior y=0 facets, so
        marker 8 is the strict-inequality filtered view (derived lazily --
        the reference itself only uses dS(8) for normals export, and the
        mouth flux trace uses the full ``interior_y0`` line).
        """
        iy = self.interior_y0
        if iy is None or self.geom is None:
            return None
        eps = 1e-12
        xL, xR = self.geom.xL, self.geom.xR
        # dolfin SubDomain.mark: predicate must hold at BOTH endpoints
        # AND the midpoint; on the y=0 line that reduces to both
        # endpoints strictly inside (xL, xR)
        x = self.vertices[iy.edges][:, :, 0]          # (F, 2)
        keep = ((x > xL + eps) & (x < xR - eps)).all(axis=1)
        idx = np.flatnonzero(keep)
        return InteriorFacetSet(
            edges=iy.edges[idx],
            cell_plus=iy.cell_plus[idx],
            local_edge_plus=iy.local_edge_plus[idx],
            cell_minus=iy.cell_minus[idx],
            local_edge_minus=iy.local_edge_minus[idx],
        )


def _edge_key(a, b):
    return np.minimum(a, b).astype(np.int64) * (1 << 32) + np.maximum(a, b)


def extract_facets(vertices: np.ndarray, cells: np.ndarray):
    """All edges of the triangulation with adjacency.

    Returns dict with:
      boundary: FacetSet (edges ordered along owning cell's CCW cycle)
      interior_edges, interior_cells (F,2), interior_local (F,2)
    """
    T = len(cells)
    # all (cell, local_edge) pairs
    cell_idx = np.repeat(np.arange(T), 3)
    local_idx = np.tile(np.arange(3), T)
    a = cells[cell_idx, _LOCAL_EDGES[local_idx, 0]]
    b = cells[cell_idx, _LOCAL_EDGES[local_idx, 1]]
    keys = _edge_key(a, b)
    order = np.argsort(keys, kind="stable")
    keys_s = keys[order]
    starts = np.flatnonzero(np.concatenate([[True], keys_s[1:] != keys_s[:-1]]))
    counts = np.diff(np.concatenate([starts, [len(keys_s)]]))

    bnd_pos = order[starts[counts == 1]]
    int_first = order[starts[counts == 2]]
    int_second = order[starts[counts == 2] + 1]

    # boundary facet: orient along the CCW cycle of the owning cell so that
    # (b - a) rotated by -90 deg is the outward normal.  For a CCW triangle
    # (v0,v1,v2) the boundary cycle is v0->v1->v2->v0; local edge pairs in
    # cycle order are: edge2=(v0,v1), edge0=(v1,v2), edge1=(v2,v0).
    cyc_a = np.array([1, 2, 0])
    cyc_b = np.array([2, 0, 1])
    bc_cell = cell_idx[bnd_pos]
    bc_local = local_idx[bnd_pos]
    ga = cells[bc_cell, cyc_a[bc_local]]
    gb = cells[bc_cell, cyc_b[bc_local]]
    boundary = FacetSet(
        edges=np.stack([ga, gb], axis=1).astype(np.int64),
        cell=bc_cell.astype(np.int64),
        local_edge=bc_local.astype(np.int64),
    )

    interior = {
        "cells": np.stack([cell_idx[int_first], cell_idx[int_second]], axis=1),
        "locals": np.stack([local_idx[int_first], local_idx[int_second]], axis=1),
        "edges": np.stack([a[int_first], b[int_first]], axis=1),
    }
    return boundary, interior

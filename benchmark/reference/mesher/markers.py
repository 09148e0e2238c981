"""Facet extraction and boundary/domain marking.
(A frozen copy of the port's ``meshing/markers.py``: the benchmark's reference
remakes each mesh with it, independent of the package under test.)

Reproduces the reference's marker semantics (mesh.py:196-256, 425-453):

  - dolfin ``SubDomain.mark`` marks a facet iff the predicate holds at BOTH
    facet vertices AND the midpoint; later entries in the marking list
    overwrite earlier ones.  We replicate this, including its (intentional)
    corner-exclusion artefacts: the flat-bottom facets touching the mouth
    corners are excluded from markers 5/7, and the curve facets touching the
    corners are excluded from marker 6, because of the strict inequalities in
    the reference predicates (mesh.py:205-212).
  - marker ids: left=1 right=2 top=3 bottom=4 (bc set, marked in that order);
    bottom_left=5 bottom_right=7 sulcus=6 sulcus_opening=8 (bottom set, in
    the reference's list order bottom_left, bottom_right, sulcus,
    sulcus_opening -- mesh.py:427); y0_line=10.
  - ``sulcus_opening`` and ``y0_line`` have no on_boundary requirement, so
    they also mark interior facets (the mouth line), which is how the
    reference's dS measures pick them up.
  - cell domain markers: 1 = cavity (centroid y<=0), 2 = channel
    (mesh.py:449-451).
"""

from __future__ import annotations

import numpy as np

from .mesh_data import (MARKERS, FacetSet, InteriorFacetSet, MeshData,
                        extract_facets)

__all__ = ["build_mesh_data", "TOL", "EPS"]

# The reference uses DOLFIN_EPS (~3e-16) and TOLERANCE = 2*DOLFIN_EPS
# (mesh.py:50).  Our mesher writes boundary coordinates exactly (0, L, H,
# 0.0), so a slightly looser-but-still-tiny tolerance gives identical
# classifications while being robust to last-ulp noise from smoothing.
TOL = 1e-12
EPS = 1e-12


def _facet_testpoints(vertices, edges):
    """(F,3,2): the two endpoints + midpoint of each facet."""
    a = vertices[edges[:, 0]]
    b = vertices[edges[:, 1]]
    mid = 0.5 * (a + b)
    return np.stack([a, b, mid], axis=1)


def _mark(test_pts, predicates_in_order, out):
    """Apply (marker_id, pred) pairs in order with overwrite semantics."""
    x = test_pts[:, :, 0]
    y = test_pts[:, :, 1]
    for marker_id, pred in predicates_in_order:
        hit = pred(x, y).all(axis=1)
        out[hit] = marker_id
    return out


def build_mesh_data(vertices, cells, geom, domain_type) -> MeshData:
    vertices = np.asarray(vertices, dtype=np.float64)
    cells = np.asarray(cells, dtype=np.int64)
    L, H = geom.width, geom.height
    xL, xR = geom.xL, geom.xR

    boundary, interior = extract_facets(vertices, cells)

    # ---- cell domain markers (ref mesh.py:449-451) ------------------------
    centroids = vertices[cells].mean(axis=1)
    if domain_type == "sulcus":
        cell_domain = np.where(centroids[:, 1] <= 0.0, 1, 2).astype(np.int32)
    else:
        cell_domain = np.full(len(cells), 2, dtype=np.int32)

    # ---- exterior facet markers ------------------------------------------
    tp = _facet_testpoints(vertices, boundary.edges)

    bc_marker = np.zeros(len(boundary), dtype=np.int32)
    _mark(tp, [
        (MARKERS["left"], lambda x, y: np.abs(x - 0.0) <= TOL),
        (MARKERS["right"], lambda x, y: np.abs(x - L) <= TOL),
        (MARKERS["top"], lambda x, y: np.abs(y - H) <= TOL),
        (MARKERS["bottom"], lambda x, y: y <= 0.0 + TOL),
    ], bc_marker)

    bottom_marker = np.zeros(len(boundary), dtype=np.int32)
    y0_marker = np.zeros(len(boundary), dtype=np.int32)
    if domain_type == "sulcus":
        _mark(tp, [
            (MARKERS["bottom_left"],
             lambda x, y: (np.abs(y) <= TOL) & (x <= xL - EPS)),
            (MARKERS["bottom_right"],
             lambda x, y: (np.abs(y) <= TOL) & (x >= xR + EPS)),
            (MARKERS["sulcus"],
             lambda x, y: (x >= xL - TOL) & (x <= xR + TOL) & (y < -EPS)),
            (MARKERS["sulcus_opening"],
             lambda x, y: (np.abs(y) <= TOL)
             & (x > xL + EPS) & (x < xR - EPS)),
        ], bottom_marker)
        _mark(tp, [
            (MARKERS["y0_line"], lambda x, y: np.abs(y) <= TOL),
        ], y0_marker)

    # ---- interior y=0 (mouth) facets -------------------------------------
    interior_y0 = None
    if domain_type == "sulcus":
        ie = interior["edges"]
        itp = _facet_testpoints(vertices, ie)
        on_y0 = (np.abs(itp[:, :, 1]) <= TOL).all(axis=1)
        idx = np.flatnonzero(on_y0)
        if len(idx):
            cells_pm = interior["cells"][idx]
            locals_pm = interior["locals"][idx]
            # '+' side = channel (domain 2), '-' side = cavity (domain 1)
            side0_dom = cell_domain[cells_pm[:, 0]]
            plus_is_0 = side0_dom == 2
            cell_plus = np.where(plus_is_0, cells_pm[:, 0], cells_pm[:, 1])
            cell_minus = np.where(plus_is_0, cells_pm[:, 1], cells_pm[:, 0])
            le_plus = np.where(plus_is_0, locals_pm[:, 0], locals_pm[:, 1])
            le_minus = np.where(plus_is_0, locals_pm[:, 1], locals_pm[:, 0])
            interior_y0 = InteriorFacetSet(
                edges=ie[idx],
                cell_plus=cell_plus.astype(np.int64),
                local_edge_plus=le_plus.astype(np.int64),
                cell_minus=cell_minus.astype(np.int64),
                local_edge_minus=le_minus.astype(np.int64),
            )

    md = MeshData(
        vertices=vertices,
        cells=cells,
        domain_type=domain_type,
        cell_domain=cell_domain,
        boundary=boundary,
        bc_marker=bc_marker,
        bottom_marker=bottom_marker,
        y0_marker=y0_marker,
        interior_y0=interior_y0,
        geom=geom,
    )
    md.info = md.mesh_info()
    return md

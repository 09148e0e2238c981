"""From-scratch unstructured triangle mesher (replaces Gmsh, ref mesh.py);
the port's copy of the JAX package's ``meshing/generator.py``, with its own
native kernel binding (``meshing/native.py``); finished meshes are kept in
the port's setup cache (``utils/diskcache.py``, tag ``port-mesh``).

Pipeline per region (the channel rectangle and, for sulcus domains, the
cavity below y=0 -- both CONVEX, see note):

  1. sample boundary polylines with the Gmsh-style graded size field
     (geometry.SulcusGeometry.size_field);
  2. seed interior points from a quadtree whose leaves track the size field;
  3. Delaunay triangulation of boundary+interior points (native kernel);
  4. a few Lloyd/Laplacian smoothing passes (re-triangulating each pass);
  5. merge the two regions along the shared, exactly-identical mouth points,
     guaranteeing the y=0 mouth line is a conforming internal interface --
     the own-mesher equivalent of Gmsh's ``Line{7} In Surface{1}``
     (ref mesh.py:310-311).

Convexity note: the channel region is a rectangle; the cavity
{xL<=x<=xR, -h sin(pi (x-xL)/w) <= y <= 0} is convex because the lower
boundary is a convex function, so Delaunay of boundary+interior points tiles
each region exactly (up to the polygonal boundary approximation) with no
hole-carving step needed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial import cKDTree

from . import native
from .geometry import SulcusGeometry, sample_curve, sample_segment
from .mesh_data import MeshData, orient_ccw
from .markers import build_mesh_data
from ..utils.diskcache import cache_key_of, count, load_arrays, store_arrays

__all__ = ["MeshGenerator", "generate_mesh", "structured_rectangle"]

MESH_TAG = "port-mesh"


# ---------------------------------------------------------------------------
# interior point seeding: size-field quadtree
# ---------------------------------------------------------------------------

def _quadtree_seeds(bbox, size_fn, s0, max_levels=14):
    """Leaf-centre seed points of a quadtree refined to the local size field."""
    x0, y0, x1, y1 = bbox
    wx, wy = x1 - x0, y1 - y0
    if wx <= 0 or wy <= 0:
        return np.zeros((0, 2))
    nx = max(1, int(np.ceil(wx / s0)))
    ny = max(1, int(np.ceil(wy / s0)))
    sx, sy = wx / nx, wy / ny
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    # normalised cell coords at level 0 (unit = level-0 cell)
    cx = (ii.ravel() + 0.5)
    cy = (jj.ravel() + 0.5)
    level = np.zeros(cx.shape[0], dtype=np.int32)

    out = []
    for _ in range(max_levels):
        scale = 0.5 ** level
        centers = np.stack([x0 + cx * sx, y0 + cy * sy], axis=1)
        cell_size = np.maximum(sx, sy) * scale
        h = size_fn(centers)
        split = cell_size > 1.35 * h
        keep = ~split
        out.append(centers[keep])
        if not split.any():
            break
        # split cells into 4 children (in the normalised coordinate system)
        pcx, pcy, plv = cx[split], cy[split], level[split]
        off = 0.25 * (0.5 ** plv)
        child_dx = np.array([-1.0, 1.0, -1.0, 1.0])
        child_dy = np.array([-1.0, -1.0, 1.0, 1.0])
        cx = (pcx[:, None] + off[:, None] * child_dx[None, :]).ravel()
        cy = (pcy[:, None] + off[:, None] * child_dy[None, :]).ravel()
        level = np.repeat(plv + 1, 4)
    else:
        # max_levels reached: keep remaining centres as-is
        scale = 0.5 ** level
        centers = np.stack([x0 + cx * sx, y0 + cy * sy], axis=1)
        out.append(centers)
    return np.concatenate(out, axis=0) if out else np.zeros((0, 2))


def _filter_seeds(seeds, fixed_pts, size_fn, inside_fn, spacing=0.65):
    """Drop seeds outside the region or too close to fixed boundary points."""
    if len(seeds) == 0:
        return seeds
    mask = inside_fn(seeds)
    seeds = seeds[mask]
    if len(seeds) == 0 or len(fixed_pts) == 0:
        return seeds
    tree = cKDTree(fixed_pts)
    d, _ = tree.query(seeds, k=1)
    h = size_fn(seeds)
    return seeds[d >= spacing * h]


# ---------------------------------------------------------------------------
# per-region triangulation + smoothing
# ---------------------------------------------------------------------------

def _filter_degenerate(pts, cells, min_area_frac=1e-9):
    v = pts
    d1 = v[cells[:, 1]] - v[cells[:, 0]]
    d2 = v[cells[:, 2]] - v[cells[:, 0]]
    area = 0.5 * np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])
    scale = np.maximum(np.linalg.norm(d1, axis=1),
                       np.linalg.norm(d2, axis=1)) ** 2
    return cells[area > min_area_frac + 1e-14 * scale]


def _triangulate(points, n_fixed, size_fn, n_smooth=4, min_area_frac=1e-9):
    """Delaunay + Lloyd-style smoothing; first ``n_fixed`` points immovable.

    Runs the native C++ mesh kernel (native/meshkernel.cpp) -- the
    framework's replacement for the reference's Gmsh subprocess.  Returns
    (points, cells), degenerate slivers dropped, CCW cells.
    """
    pts, cells = native.smooth_and_triangulate(points, n_fixed,
                                               max(0, n_smooth))
    cells = _filter_degenerate(pts, cells, min_area_frac)
    return pts, orient_ccw(pts, cells)


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------

def _dedupe_polyline(chains):
    """Concatenate point chains, dropping the duplicated joint points."""
    pts = [chains[0]]
    for c in chains[1:]:
        pts.append(c[1:])
    out = np.concatenate(pts, axis=0)
    # closed loop: last point may equal first
    if np.allclose(out[0], out[-1]):
        out = out[:-1]
    return out


def _mesh_to_arrays(md: MeshData):
    out = {"vertices": md.vertices, "cells": md.cells,
           "cell_domain": md.cell_domain, "bc_marker": md.bc_marker,
           "bottom_marker": md.bottom_marker, "y0_marker": md.y0_marker,
           "b_edges": md.boundary.edges, "b_cell": md.boundary.cell,
           "b_local": md.boundary.local_edge}
    iy = md.interior_y0
    if iy is not None:
        out.update({"iy_edges": iy.edges, "iy_cp": iy.cell_plus,
                    "iy_lp": iy.local_edge_plus, "iy_cm": iy.cell_minus,
                    "iy_lm": iy.local_edge_minus})
    return out


def _mesh_from_arrays(d, geom, domain_type) -> MeshData:
    from .mesh_data import FacetSet, InteriorFacetSet
    iy = None
    if "iy_edges" in d:
        iy = InteriorFacetSet(edges=d["iy_edges"], cell_plus=d["iy_cp"],
                              local_edge_plus=d["iy_lp"],
                              cell_minus=d["iy_cm"],
                              local_edge_minus=d["iy_lm"])
    return MeshData(vertices=d["vertices"], cells=d["cells"],
                    domain_type=domain_type,
                    cell_domain=d["cell_domain"],
                    boundary=FacetSet(edges=d["b_edges"],
                                      cell=d["b_cell"],
                                      local_edge=d["b_local"]),
                    bc_marker=d["bc_marker"],
                    bottom_marker=d["bottom_marker"],
                    y0_marker=d["y0_marker"], interior_y0=iy, geom=geom)


def generate_mesh(width, height, sulcus_depth, sulcus_width, mesh_size,
                  refinement_factor=1, domain_type="sulcus",
                  n_smooth=4) -> MeshData:
    """Generate a sulcus or rectangular channel mesh (ref mesh.py:504-598).

    The triangulation is pure in its scalar arguments, so the finished
    MeshData is persisted across processes (an .npz per argument set):
    study drivers regenerate the same meshes every run, and the native
    kernel + marker build cost ~0.7 s at h=0.02."""
    key = cache_key_of("mesh-v1", float(width), float(height),
                       float(sulcus_depth), float(sulcus_width),
                       float(mesh_size), int(refinement_factor), domain_type,
                       int(n_smooth))
    hit = load_arrays(MESH_TAG, key)
    geom_c = SulcusGeometry(width=width, height=height,
                            sulcus_width=sulcus_width,
                            sulcus_depth=sulcus_depth,
                            mesh_size=mesh_size,
                            refinement_factor=int(refinement_factor))
    dt = ("rectangular" if domain_type == "rectangular"
          or sulcus_width <= 0 or sulcus_depth <= 0 else "sulcus")
    if hit is not None:
        return _mesh_from_arrays(hit, geom_c, dt)
    count(MESH_TAG, "miss")
    md = _generate_mesh_impl(width, height, sulcus_depth, sulcus_width,
                             mesh_size, refinement_factor, domain_type,
                             n_smooth)
    store_arrays(MESH_TAG, key, _mesh_to_arrays(md))
    return md


def _generate_mesh_impl(width, height, sulcus_depth, sulcus_width,
                        mesh_size, refinement_factor=1,
                        domain_type="sulcus", n_smooth=4) -> MeshData:
    geom = SulcusGeometry(width=width, height=height,
                          sulcus_width=sulcus_width,
                          sulcus_depth=sulcus_depth,
                          mesh_size=mesh_size,
                          refinement_factor=int(refinement_factor))
    fld = geom.size_field
    L, H = float(width), float(height)
    xL, xR = geom.xL, geom.xR

    if domain_type == "rectangular" or sulcus_width <= 0 or sulcus_depth <= 0:
        # one convex region; size field still refines near the (imaginary)
        # sulcus nodes, matching the reference's rectangular .geo
        # (mesh.py:328-339 with is_sulcus=False).
        bottom = sample_segment([0.0, 0.0], [L, 0.0], fld)
        right = sample_segment([L, 0.0], [L, H], fld)
        top = sample_segment([L, H], [0.0, H], fld)
        left = sample_segment([0.0, H], [0.0, 0.0], fld)
        outline = _dedupe_polyline([bottom, right, top, left])
        seeds = _quadtree_seeds((0.0, 0.0, L, H), fld, s0=geom.lc)

        def inside(p):
            return ((p[:, 0] > 0) & (p[:, 0] < L)
                    & (p[:, 1] > 0) & (p[:, 1] < H))

        seeds = _filter_seeds(seeds, outline, fld, inside)
        pts = np.concatenate([outline, seeds], axis=0)
        pts, cells = _triangulate(pts, len(outline), fld, n_smooth=n_smooth)
        return build_mesh_data(pts, cells, geom, "rectangular")

    # ---- sulcus domain: channel + cavity, shared mouth line ---------------
    mouth = sample_segment([xL, 0.0], [xR, 0.0], fld, min_segments=4)
    bl = sample_segment([0.0, 0.0], [xL, 0.0], fld)
    br = sample_segment([xR, 0.0], [L, 0.0], fld)
    right = sample_segment([L, 0.0], [L, H], fld)
    top = sample_segment([L, H], [0.0, H], fld)
    left = sample_segment([0.0, H], [0.0, 0.0], fld)
    curve = sample_curve(geom, fld, min_segments=6)

    # channel region (the full rectangle; mouth points sit on its bottom edge)
    chan_outline = _dedupe_polyline([bl, mouth, br, right, top, left])
    chan_seeds = _quadtree_seeds((0.0, 0.0, L, H), fld, s0=geom.lc)

    def inside_chan(p):
        return ((p[:, 0] > 0) & (p[:, 0] < L)
                & (p[:, 1] > 0) & (p[:, 1] < H))

    chan_seeds = _filter_seeds(chan_seeds, chan_outline, fld, inside_chan)
    chan_pts = np.concatenate([chan_outline, chan_seeds], axis=0)
    chan_pts, chan_cells = _triangulate(
        chan_pts, len(chan_outline), fld, n_smooth=n_smooth)

    # cavity region (convex: mouth chord above, sine dip below)
    cav_outline = _dedupe_polyline([mouth, curve[::-1]])
    cav_seeds = _quadtree_seeds(
        (xL, -geom.sulcus_depth, xR, 0.0), fld, s0=min(geom.lc, max(
            geom.sulcus_width, geom.sulcus_depth)))

    def inside_cav(p):
        yb = geom.curve_y(p[:, 0])
        return ((p[:, 0] > xL) & (p[:, 0] < xR)
                & (p[:, 1] < 0) & (p[:, 1] > yb))

    cav_seeds = _filter_seeds(cav_seeds, cav_outline, fld, inside_cav)
    cav_pts = np.concatenate([cav_outline, cav_seeds], axis=0)
    cav_pts, cav_cells = _triangulate(
        cav_pts, len(cav_outline), fld, n_smooth=n_smooth)

    # ---- merge along the mouth (exact float equality on shared points) ----
    merged, cells = _merge_regions(chan_pts, chan_cells, cav_pts, cav_cells)
    return build_mesh_data(merged, cells, geom, "sulcus")


def _merge_regions(pts_a, cells_a, pts_b, cells_b):
    """Merge two triangulations that share exactly-equal boundary points."""
    key_to_idx = {}
    for i, p in enumerate(pts_a):
        key_to_idx[(p[0], p[1])] = i
    map_b = np.zeros(len(pts_b), dtype=np.int64)
    extra = []
    for j, p in enumerate(pts_b):
        k = (p[0], p[1])
        if k in key_to_idx:
            map_b[j] = key_to_idx[k]
        else:
            idx = len(pts_a) + len(extra)
            key_to_idx[k] = idx
            map_b[j] = idx
            extra.append(p)
    merged = (np.concatenate([pts_a, np.asarray(extra).reshape(-1, 2)], axis=0)
              if extra else pts_a.copy())
    cells = np.concatenate([cells_a, map_b[cells_b]], axis=0)
    return merged, cells


def structured_rectangle(L, H, nx, ny):
    """Structured right-triangle mesh of [0,L]x[0,H] (tests/benchmarks)."""
    x = np.linspace(0.0, L, nx + 1)
    y = np.linspace(0.0, H, ny + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    pts = np.stack([X.ravel(), Y.ravel()], axis=1)

    def vid(i, j):
        return i * (ny + 1) + j

    cells = []
    for i in range(nx):
        for j in range(ny):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            cells.append([v00, v10, v11])
            cells.append([v00, v11, v01])
    cells = np.asarray(cells, dtype=np.int64)
    geom = SulcusGeometry(width=L, height=H, sulcus_width=0.0,
                          sulcus_depth=0.0, mesh_size=max(L / nx, H / ny))
    return build_mesh_data(pts, orient_ccw(pts, cells), geom, "rectangular")


class MeshGenerator:
    """Drop-in style front-end mirroring the reference MeshGenerator API
    (mesh.py:29-598): same constructor arguments, ``generate_mesh()`` returns
    a dict with the same keys (mesh / markers / mesh_info)."""

    MARKERS = {
        "left": 1, "right": 2, "top": 3, "bottom": 4,
        "bottom_left": 5, "sulcus": 6, "bottom_right": 7,
        "sulcus_opening": 8, "y0_line": 10,
    }

    def __init__(self, width, height, sulcus_depth, sulcus_width,
                 mesh_size, refinement_factor, domain_type, output_dir=None):
        valid = ["sulcus", "rectangular"]
        if domain_type not in valid:
            raise ValueError(f"domain_type must be one of {valid}")
        if width <= 0 or height <= 0 or mesh_size <= 0:
            raise ValueError("width/height/mesh_size must be positive")
        if domain_type == "sulcus":
            if sulcus_width <= 0 or sulcus_depth <= 0:
                raise ValueError("Sulcus dimensions must be positive")
            if sulcus_width >= width:
                raise ValueError(
                    "Sulcus width must be less than channel width")
        self.width, self.height = width, height
        self.sulcus_depth, self.sulcus_width = sulcus_depth, sulcus_width
        self.mesh_size = mesh_size
        self.refinement_factor = refinement_factor
        self.domain_type = domain_type
        self.output_dir = output_dir
        self.mesh_data: Optional[MeshData] = None

    def generate_mesh(self) -> Optional[Dict]:
        md = generate_mesh(
            self.width, self.height, self.sulcus_depth, self.sulcus_width,
            self.mesh_size, self.refinement_factor, self.domain_type)
        self.mesh_data = md
        result = {"mesh": md, "mesh_info": md.mesh_info()}
        if self.domain_type == "sulcus":
            result.update({
                "bc_markers": md.bc_marker,
                "bottom_segment_markers": md.bottom_marker,
                "y0_markers": md.y0_marker,
                "domain_markers": md.cell_domain,
            })
        else:
            result["bc_markers"] = md.bc_marker
        return result

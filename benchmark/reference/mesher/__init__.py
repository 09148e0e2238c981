"""The benchmark's reference mesher: a frozen copy of the port's mesh
pipeline (``meshing/generator.py`` without its setup cache, ``geometry.py``,
``markers.py``, ``mesh_data.py``) and of ``native/meshkernel.cpp``.

The kernel is compiled with g++ and the port's flags (so the same source
gives the same bits) into ``build/benchmark/mesher/`` at the root of the
checkout, named by a hash of the source and flags: only the first run in
a checkout compiles.  ``generate_mesh`` remakes the mesh of one geometry;
the check holds the port's mesh to it entry for entry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
from scipy.spatial import cKDTree

from .geometry import SulcusGeometry, sample_curve, sample_segment
from .markers import build_mesh_data
from .mesh_data import MeshData, orient_ccw

__all__ = ["generate_mesh", "library_path"]

_SRC = Path(__file__).resolve().with_name("meshkernel.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "benchmark" / \
    "mesher"
_CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libbenchmesh_{h.hexdigest()[:16]}.so"


def _library():
    global _lib
    if _lib is None:
        path = library_path()
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", str(tmp),
                   str(_SRC)]
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"reference mesher build failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        lib.feu_smooth.restype = ctypes.c_int64
        lib.feu_smooth.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64]
        _lib = lib
    return _lib


def _smooth_and_triangulate(points, n_fixed, n_iters):
    pts = np.ascontiguousarray(points, dtype=np.float64).copy()
    n = len(pts)
    max_tris = 2 * n + 16
    out = np.empty((max_tris, 3), dtype=np.int64)
    t = _library().feu_smooth(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n, n_fixed,
        n_iters, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        max_tris)
    if t < 0:
        raise RuntimeError(f"reference mesher failed ({t}) on {n} points")
    return pts, out[:t].copy()


def _quadtree_seeds(bbox, size_fn, s0, max_levels=14):
    x0, y0, x1, y1 = bbox
    wx, wy = x1 - x0, y1 - y0
    if wx <= 0 or wy <= 0:
        return np.zeros((0, 2))
    nx = max(1, int(np.ceil(wx / s0)))
    ny = max(1, int(np.ceil(wy / s0)))
    sx, sy = wx / nx, wy / ny
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
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
        pcx, pcy, plv = cx[split], cy[split], level[split]
        off = 0.25 * (0.5 ** plv)
        child_dx = np.array([-1.0, 1.0, -1.0, 1.0])
        child_dy = np.array([-1.0, -1.0, 1.0, 1.0])
        cx = (pcx[:, None] + off[:, None] * child_dx[None, :]).ravel()
        cy = (pcy[:, None] + off[:, None] * child_dy[None, :]).ravel()
        level = np.repeat(plv + 1, 4)
    else:
        centers = np.stack([x0 + cx * sx, y0 + cy * sy], axis=1)
        out.append(centers)
    return np.concatenate(out, axis=0) if out else np.zeros((0, 2))


def _filter_seeds(seeds, fixed_pts, size_fn, inside_fn, spacing=0.65):
    if len(seeds) == 0:
        return seeds
    seeds = seeds[inside_fn(seeds)]
    if len(seeds) == 0 or len(fixed_pts) == 0:
        return seeds
    d, _ = cKDTree(fixed_pts).query(seeds, k=1)
    return seeds[d >= spacing * size_fn(seeds)]


def _filter_degenerate(pts, cells, min_area_frac=1e-9):
    d1 = pts[cells[:, 1]] - pts[cells[:, 0]]
    d2 = pts[cells[:, 2]] - pts[cells[:, 0]]
    area = 0.5 * np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])
    scale = np.maximum(np.linalg.norm(d1, axis=1),
                       np.linalg.norm(d2, axis=1)) ** 2
    return cells[area > min_area_frac + 1e-14 * scale]


def _triangulate(points, n_fixed, n_smooth=4):
    pts, cells = _smooth_and_triangulate(points, n_fixed, max(0, n_smooth))
    cells = _filter_degenerate(pts, cells)
    return pts, orient_ccw(pts, cells)


def _dedupe_polyline(chains):
    out = np.concatenate([chains[0]] + [c[1:] for c in chains[1:]], axis=0)
    if np.allclose(out[0], out[-1]):
        out = out[:-1]
    return out


def _merge_regions(pts_a, cells_a, pts_b, cells_b):
    key_to_idx = {(p[0], p[1]): i for i, p in enumerate(pts_a)}
    map_b = np.zeros(len(pts_b), dtype=np.int64)
    extra = []
    for j, p in enumerate(pts_b):
        k = (p[0], p[1])
        if k not in key_to_idx:
            key_to_idx[k] = len(pts_a) + len(extra)
            extra.append(p)
        map_b[j] = key_to_idx[k]
    merged = (np.concatenate([pts_a, np.asarray(extra).reshape(-1, 2)],
                             axis=0) if extra else pts_a.copy())
    return merged, np.concatenate([cells_a, map_b[cells_b]], axis=0)


def generate_mesh(width, height, sulcus_depth, sulcus_width, mesh_size,
                  refinement_factor=1, domain_type="sulcus",
                  n_smooth=4) -> MeshData:
    """The mesh of one geometry, as the port's ``generate_mesh`` makes it
    (nondimensional lengths)."""
    geom = SulcusGeometry(width=width, height=height,
                          sulcus_width=sulcus_width,
                          sulcus_depth=sulcus_depth, mesh_size=mesh_size,
                          refinement_factor=int(refinement_factor))
    fld = geom.size_field
    L, H = float(width), float(height)
    xL, xR = geom.xL, geom.xR
    if domain_type == "rectangular" or sulcus_width <= 0 or sulcus_depth <= 0:
        outline = _dedupe_polyline([
            sample_segment([0.0, 0.0], [L, 0.0], fld),
            sample_segment([L, 0.0], [L, H], fld),
            sample_segment([L, H], [0.0, H], fld),
            sample_segment([0.0, H], [0.0, 0.0], fld)])
        seeds = _quadtree_seeds((0.0, 0.0, L, H), fld, s0=geom.lc)
        seeds = _filter_seeds(seeds, outline, fld, lambda p: (
            (p[:, 0] > 0) & (p[:, 0] < L) & (p[:, 1] > 0) & (p[:, 1] < H)))
        pts, cells = _triangulate(np.concatenate([outline, seeds], axis=0),
                                  len(outline), n_smooth=n_smooth)
        return build_mesh_data(pts, cells, geom, "rectangular")

    mouth = sample_segment([xL, 0.0], [xR, 0.0], fld, min_segments=4)
    bl = sample_segment([0.0, 0.0], [xL, 0.0], fld)
    br = sample_segment([xR, 0.0], [L, 0.0], fld)
    right = sample_segment([L, 0.0], [L, H], fld)
    top = sample_segment([L, H], [0.0, H], fld)
    left = sample_segment([0.0, H], [0.0, 0.0], fld)
    curve = sample_curve(geom, fld, min_segments=6)

    chan_outline = _dedupe_polyline([bl, mouth, br, right, top, left])
    chan_seeds = _filter_seeds(
        _quadtree_seeds((0.0, 0.0, L, H), fld, s0=geom.lc), chan_outline,
        fld, lambda p: ((p[:, 0] > 0) & (p[:, 0] < L)
                        & (p[:, 1] > 0) & (p[:, 1] < H)))
    chan_pts, chan_cells = _triangulate(
        np.concatenate([chan_outline, chan_seeds], axis=0),
        len(chan_outline), n_smooth=n_smooth)

    cav_outline = _dedupe_polyline([mouth, curve[::-1]])
    cav_seeds = _quadtree_seeds(
        (xL, -geom.sulcus_depth, xR, 0.0), fld, s0=min(geom.lc, max(
            geom.sulcus_width, geom.sulcus_depth)))

    def inside_cav(p):
        yb = geom.curve_y(p[:, 0])
        return ((p[:, 0] > xL) & (p[:, 0] < xR)
                & (p[:, 1] < 0) & (p[:, 1] > yb))

    cav_seeds = _filter_seeds(cav_seeds, cav_outline, fld, inside_cav)
    cav_pts, cav_cells = _triangulate(
        np.concatenate([cav_outline, cav_seeds], axis=0), len(cav_outline),
        n_smooth=n_smooth)
    merged, cells = _merge_regions(chan_pts, chan_cells, cav_pts, cav_cells)
    return build_mesh_data(merged, cells, geom, "sulcus")

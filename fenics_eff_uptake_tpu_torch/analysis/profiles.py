"""Point evaluation, line profiles and the velocity line metrics (host
numpy).

Copies of ``eval_function``, ``extract_line_profile``,
``compute_conc_profiles`` and ``compute_velocity_metrics`` from the JAX
package's ``analysis/profiles.py``: that module is numpy-only, but
importing it runs ``analysis/__init__.py``, which loads jax.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..fem.elements import tabulate
from .locate import PointLocator

__all__ = ["eval_function", "extract_line_profile", "compute_conc_profiles",
           "compute_velocity_metrics"]


def eval_function(fn, pts, locator: Optional[PointLocator] = None):
    """Evaluate a scalar or vector Function (numpy values) at points.

    Returns (values (N,) or (N, 2), valid (N,) bool)."""
    space = fn.space
    if locator is None:
        locator = PointLocator(space.mesh)
    cells, ref = locator.locate(pts)
    valid = cells >= 0
    safe_cells = np.where(valid, cells, 0)
    phi = tabulate(space.element, ref)                 # (N, nd)
    vals_np = np.asarray(fn.values)
    if space.vs == 1:
        out = (phi * vals_np[space.cell_dofs[safe_cells]]).sum(1)
    else:
        ce = vals_np[space.cell_dofs[safe_cells]].reshape(len(cells), -1, 2)
        out = np.einsum("ni,nia->na", phi, ce)
    return out, valid


def extract_line_profile(fn, axis: str, location: float, span, n_points=100,
                         locator: Optional[PointLocator] = None):
    """(coords, values) of ``fn`` sampled at ``n_points`` even steps over
    ``span`` along a horizontal (axis "x", y = location) or vertical (axis
    "y", x = location) line; points outside the mesh are dropped."""
    lo, hi = span
    coords = np.linspace(lo, hi, n_points)
    if axis == "x":
        pts = np.stack([coords, np.full_like(coords, location)], axis=1)
    else:
        pts = np.stack([np.full_like(coords, location), coords], axis=1)
    vals, valid = eval_function(fn, pts, locator)
    return coords[valid], vals[valid]


def compute_conc_profiles(c, mesh, params, domain_type, n_points=400):
    """The standard line profiles of a concentration: per line its
    statistics (``profiles``), its samples (``profiles_full``) and the
    sampling metadata (``profiles_meta``), the reference's structure.
    Horizontal lines at the sulcus middle (sulcus domains), the mouth
    level and a quarter, half and three quarters of the channel height;
    vertical lines at a quarter, half and three quarters of its length."""
    L = float(getattr(params, "L", getattr(params, "L_dim", 1.0)))
    H = float(getattr(params, "H", getattr(params, "H_dim", 1.0)))
    locator = PointLocator(mesh)
    if domain_type == "rectangular":
        horiz = [(1e-6 * H, "mouth_level"), (0.25 * H, "lower_channel"),
                 (0.50 * H, "mid_channel"), (0.75 * H, "upper_channel")]
        x_range = (0.0, L)
        y_range = (0.0, H)
    else:
        y_min = float(mesh.vertices[:, 1].min())
        horiz = [(0.5 * y_min, "sulcus_mid"), (1e-6 * H, "mouth_level"),
                 (0.25 * H, "lower_channel"), (0.50 * H, "mid_channel"),
                 (0.75 * H, "upper_channel")]
        x_range = (float(mesh.vertices[:, 0].min()),
                   float(mesh.vertices[:, 0].max()))
        y_range = (y_min, float(mesh.vertices[:, 1].max()))
    vert = [(0.25 * L, "x_quarter"), (0.50 * L, "x_mid"),
            (0.75 * L, "x_three_quarters")]

    stats = {"horizontal": {}, "vertical": {}}
    full = {"horizontal": {}, "vertical": {}}
    for ltype, fixed, axis, span, lines in (
            ("horizontal", "y", "x", x_range, horiz),
            ("vertical", "x", "y", y_range, vert)):
        for loc, name in lines:
            pos, vs = extract_line_profile(c, axis, loc, span, n_points,
                                           locator)
            if vs.size == 0:
                continue
            stats[ltype][name] = {
                fixed: float(loc), "min_c": float(vs.min()),
                "max_c": float(vs.max()), "avg_c": float(vs.mean()),
                "n_samples": int(vs.size)}
            full[ltype][name] = {fixed: float(loc), axis: pos.tolist(),
                                 "c": vs.tolist()}
    return {
        "profiles": stats,
        "profiles_full": full,
        "profiles_meta": {
            "n_points": int(n_points),
            "domain_type": domain_type,
            "x_range": tuple(map(float, x_range)),
            "y_range": tuple(map(float, y_range)),
        },
    }


def compute_velocity_metrics(u, mesh, params, n_global=1000, seed=0):
    """Velocity line and global statistics, the reference's metric keys
    (the global vertex sample is seeded, as in the JAX package)."""
    if u is None:
        return {}
    if getattr(params, "mode", "unknown") not in ("adv-diff", "no-uptake"):
        return {}
    L = float(params.L)
    H = float(params.H)
    sulcus_w = float(getattr(params, "sulci_w", 0.0))
    cx = L / 2
    locator = PointLocator(mesh)
    out = {}

    def hline(y_loc, name):
        xs = np.linspace(0, L, 100)
        pts = np.stack([xs, np.full_like(xs, y_loc)], axis=1)
        vals, valid = eval_function(u, pts, locator)
        v = vals[valid]
        if len(v):
            umag = np.linalg.norm(v, axis=1)
            out[f"max_ux_{name}"] = float(np.abs(v[:, 0]).max())
            out[f"max_umag_{name}"] = float(umag.max())
            out[f"avg_ux_{name}"] = float(np.abs(v[:, 0]).mean())
            out[f"avg_umag_{name}"] = float(umag.mean())
        else:
            for k in ("max_ux", "max_umag", "avg_ux", "avg_umag"):
                out[f"{k}_{name}"] = 0

    def vline(x_loc, name):
        ys = np.linspace(0, H, 100)
        pts = np.stack([np.full_like(ys, x_loc), ys], axis=1)
        vals, valid = eval_function(u, pts, locator)
        v = vals[valid]
        if len(v):
            umag = np.linalg.norm(v, axis=1)
            out[f"max_umag_{name}"] = float(umag.max())
            out[f"max_uy_{name}"] = float(np.abs(v[:, 1]).max())
            out[f"avg_umag_{name}"] = float(umag.mean())
            out[f"avg_uy_{name}"] = float(np.abs(v[:, 1]).mean())
        else:
            for k in ("max_umag", "max_uy", "avg_umag", "avg_uy"):
                out[f"{k}_{name}"] = 0

    for y_loc, name in [(1e-6 * H, "mouth_level"),
                        (0.25 * H, "lower_channel"),
                        (0.50 * H, "mid_channel"),
                        (0.75 * H, "upper_channel")]:
        if 0 <= y_loc <= H:
            hline(y_loc, name)
    for x_loc, name in [(cx - sulcus_w / 2, "sulcus_leading"),
                        (cx, "sulcus_center"),
                        (cx + sulcus_w / 2, "sulcus_trailing")]:
        if 0 <= x_loc <= L:
            vline(x_loc, name)

    coords = mesh.vertices
    n_sample = min(n_global, len(coords))
    idx = np.random.RandomState(seed).choice(len(coords), n_sample,
                                             replace=False)
    vals, valid = eval_function(u, coords[idx], locator)
    v = vals[valid]
    if len(v):
        umag = np.linalg.norm(v, axis=1)
        out["global_max_umag"] = float(umag.max())
        out["global_avg_umag"] = float(umag.mean())
        out["global_max_ux"] = float(np.abs(v[:, 0]).max())
        out["global_avg_ux"] = float(np.abs(v[:, 0]).mean())
        out["global_max_uy"] = float(np.abs(v[:, 1]).max())
        out["global_avg_uy"] = float(np.abs(v[:, 1]).mean())
    else:
        for k in ("global_max_umag", "global_avg_umag", "global_max_ux",
                  "global_avg_ux", "global_max_uy", "global_avg_uy"):
            out[k] = 0
    return out

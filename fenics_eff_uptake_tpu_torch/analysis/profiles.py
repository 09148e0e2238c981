"""Point evaluation and the velocity line metrics (host numpy).

Copies of ``eval_function`` and ``compute_velocity_metrics`` from the JAX
package's ``analysis/profiles.py``: that module is numpy-only, but
importing it runs ``analysis/__init__.py``, which loads jax.  The line
profiles of the concentration (``compute_conc_profiles``) are not ported
yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..fem.elements import tabulate
from .locate import PointLocator

__all__ = ["eval_function", "compute_velocity_metrics"]


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

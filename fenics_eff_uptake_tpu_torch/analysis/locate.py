"""Point location in a triangle mesh (host numpy).

A copy of ``PointLocator`` from the JAX package's ``analysis/profiles.py``:
that module is numpy-only, but importing it runs ``analysis/__init__.py``,
which loads jax.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy.spatial import cKDTree

__all__ = ["PointLocator"]


class PointLocator:
    """Locate points via a centroid KD-tree + barycentric inside test."""

    def __init__(self, mesh, k=24, tol=1e-10):
        self.mesh = mesh
        v = mesh.vertices
        c = mesh.cells
        self.p0 = v[c[:, 0]]
        d1 = v[c[:, 1]] - self.p0
        d2 = v[c[:, 2]] - self.p0
        det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
        self.inv = np.stack([
            np.stack([d2[:, 1], -d2[:, 0]], axis=1),
            np.stack([-d1[:, 1], d1[:, 0]], axis=1),
        ], axis=1) / det[:, None, None]
        self.tree = cKDTree(v[c].mean(axis=1))
        self.k = min(k, len(c))
        self.tol = tol

    def locate(self, pts) -> Tuple[np.ndarray, np.ndarray]:
        """(cell_idx (N,), ref_coords (N, 2)); cell_idx = -1 if outside."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        _, cand = self.tree.query(pts, k=self.k, workers=-1)
        cand = np.atleast_2d(cand)
        rel = pts[:, None, :] - self.p0[cand]
        ref = np.einsum("nkab,nkb->nka", self.inv[cand], rel)
        lam0 = 1.0 - ref[..., 0] - ref[..., 1]
        inside = ((ref[..., 0] >= -self.tol) & (ref[..., 1] >= -self.tol)
                  & (lam0 >= -self.tol))
        first = inside.argmax(axis=1)
        found = inside.any(axis=1)
        cells = np.where(found, cand[np.arange(len(pts)), first], -1)
        refc = ref[np.arange(len(pts)), first]
        return cells, refc

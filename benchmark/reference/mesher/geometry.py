"""Sulcus-channel geometry: curve, size field, boundary sampling.
(A frozen copy of the port's ``meshing/geometry.py``: the benchmark's reference
remakes each mesh with it, independent of the package under test.)

Reproduces the geometric content of the reference's Gmsh ``.geo`` generation
(mesh.py:139-348) without Gmsh:

  - the sinusoidal sulcus dip y = -h * sin(pi * x_rel) over the mouth
    [xL, xR] (mesh.py:154), with the 21 control nodes used by the Distance
    refinement field (mesh.py:139-155, 331);
  - the Threshold size field lc_fine -> lc ramped linearly between
    DistMin = w/10 and DistMax = w/2 from those nodes (mesh.py:333-337);
  - arc-length-adaptive sampling of straight segments and of the curve.

The reference meshes a Catmull/cubic *spline through 21 samples* of the sine;
we sample the exact sine densely instead (strictly closer to the intended
geometry; documented deviation).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["SulcusGeometry", "sample_segment", "sample_curve"]


@dataclass(frozen=True)
class SulcusGeometry:
    """Nondimensional channel + single centred sulcus geometry."""

    width: float            # L
    height: float           # H
    sulcus_width: float     # w  (0 => no sulcus / rectangular)
    sulcus_depth: float     # h
    mesh_size: float        # lc
    refinement_factor: int = 1

    N_FIELD_NODES = 21      # ref mesh.py:40 (N_SULCUS_SEGMENTS=20 -> 21 nodes)

    @property
    def xL(self):
        return self.width / 2 - self.sulcus_width / 2  # ref mesh.py:100

    @property
    def xR(self):
        return self.width / 2 + self.sulcus_width / 2

    @property
    def lc(self):
        return self.mesh_size

    @property
    def lc_fine(self):
        return self.mesh_size / self.refinement_factor  # ref mesh.py:266

    # -- the sulcus curve --------------------------------------------------
    def curve_y(self, x):
        """y(x) = -h sin(pi (x-xL)/w) on [xL, xR] (ref mesh.py:154)."""
        x = np.asarray(x, dtype=np.float64)
        t = (x - self.xL) / self.sulcus_width
        return -self.sulcus_depth * np.sin(np.pi * np.clip(t, 0.0, 1.0))

    def curve_point(self, t):
        """Curve point at parameter t in [0,1]."""
        t = np.asarray(t, dtype=np.float64)
        x = self.xL + t * self.sulcus_width
        y = -self.sulcus_depth * np.sin(np.pi * t)
        return np.stack([x, y], axis=-1)

    def field_nodes(self):
        """The 21 Distance-field control nodes (ref mesh.py:144-155).

        Endpoints are clamped to y=0 exactly, matching the reference.
        """
        i = np.arange(self.N_FIELD_NODES)
        t = i / (self.N_FIELD_NODES - 1)
        x = self.xL + t * self.sulcus_width
        y = np.where((i > 0) & (i < self.N_FIELD_NODES - 1),
                     -self.sulcus_depth * np.sin(np.pi * t), 0.0)
        return np.stack([x, y], axis=1)

    # -- size field (Gmsh Distance+Threshold, ref mesh.py:328-339) ---------
    def size_field(self, pts):
        """Target edge length h(p) at points pts (N,2)."""
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        if self.sulcus_width <= 0:
            return np.full(pts.shape[0], self.lc)
        nodes = self.field_nodes()
        # distance to nearest control node
        d = np.sqrt(((pts[:, None, :] - nodes[None, :, :]) ** 2).sum(-1)).min(1)
        dist_min = self.sulcus_width / 10.0   # ref mesh.py:336
        dist_max = self.sulcus_width / 2.0    # ref mesh.py:337
        t = np.clip((d - dist_min) / max(dist_max - dist_min, 1e-300), 0.0, 1.0)
        return self.lc_fine + (self.lc - self.lc_fine) * t

    def size_at(self, p):
        return float(self.size_field(np.asarray(p, dtype=np.float64)[None, :])[0])


def sample_segment(a, b, size_fn, min_segments=1):
    """Sample a straight segment [a,b] with local spacing from ``size_fn``.

    Returns points INCLUDING both endpoints, exactly a and b.  The step count
    is chosen by integrating 1/h along the segment so graded fields produce
    graded spacing.
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    length = float(np.linalg.norm(b - a))
    if length == 0.0:
        return np.array([a])
    # integrate density 1/h along the segment on a fine probe grid
    n_probe = max(16, int(length / _min_size_along(a, b, size_fn) * 4))
    n_probe = min(n_probe, 20000)
    t = np.linspace(0.0, 1.0, n_probe)
    probe = a[None, :] + t[:, None] * (b - a)[None, :]
    h = np.maximum(size_fn(probe), 1e-12)
    density = 1.0 / h
    cum = np.concatenate([[0.0], np.cumsum(
        0.5 * (density[1:] + density[:-1]) * np.diff(t) * length)])
    n_seg = max(min_segments, int(round(cum[-1])))
    targets = np.linspace(0.0, cum[-1], n_seg + 1)
    tt = np.interp(targets, cum, t)
    pts = a[None, :] + tt[:, None] * (b - a)[None, :]
    pts[0] = a
    pts[-1] = b
    return pts


def _min_size_along(a, b, size_fn, n=64):
    t = np.linspace(0.0, 1.0, n)
    probe = a[None, :] + t[:, None] * (b - a)[None, :]
    return float(np.maximum(size_fn(probe), 1e-12).min())


def sample_curve(geom: SulcusGeometry, size_fn, min_segments=6):
    """Sample the sulcus sine curve adaptively by arc length.

    Returns points from (xL, 0) to (xR, 0) inclusive; endpoints exact.
    """
    # fine parameter probe of the exact curve
    n_probe = 4096
    t = np.linspace(0.0, 1.0, n_probe)
    pts = geom.curve_point(t)
    seg = np.linalg.norm(np.diff(pts, axis=0), axis=1)
    arclen = np.concatenate([[0.0], np.cumsum(seg)])
    h = np.maximum(size_fn(pts), 1e-12)
    density = 1.0 / h
    cum = np.concatenate([[0.0], np.cumsum(
        0.5 * (density[1:] + density[:-1]) * seg)])
    n_seg = max(min_segments, int(round(cum[-1])))
    targets = np.linspace(0.0, cum[-1], n_seg + 1)
    tt = np.interp(targets, cum, t)
    out = geom.curve_point(tt)
    out[0] = [geom.xL, 0.0]
    out[-1] = [geom.xR, 0.0]
    return out

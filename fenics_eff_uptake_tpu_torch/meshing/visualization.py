"""Mesh, marker and facet-normal exports for ParaView (counterpart of
``meshing/visualization.py``; the reference's ``save_mesh_pvd_files``).

Legacy VTK, byte for byte the JAX package's: the mesh with its domain
markers, the boundary facets as lines with each marker set's ids, and per
marker id the outward unit facet normals as point vectors at the facet
midpoints.  The normals are exact per facet, from the CCW cell
orientation (the reference solves a boundary mass-matrix system per
marker for them).
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.vtk import _points, write_vtk_mesh
from .mesh_data import MARKERS, MeshData

__all__ = ["save_mesh_visualization"]


def _write_vtk_lines(path, points, lines, cell_data, title):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(f"# vtk DataFile Version 3.0\n{title}\nASCII\n")
        f.write("DATASET POLYDATA\n")
        f.write(f"POINTS {len(points)} double\n")
        _points(f, points)
        f.write(f"LINES {len(lines)} {3 * len(lines)}\n")
        f.write("".join(f"2 {a} {b}\n" for a, b in np.asarray(lines).tolist()))
        if cell_data:
            f.write(f"CELL_DATA {len(lines)}\n")
            for name, arr in cell_data.items():
                f.write(f"SCALARS {name} int 1\nLOOKUP_TABLE default\n")
                f.write("".join(f"{int(v)}\n" for v in arr))


def _facet_normals(mesh: MeshData):
    """Outward unit normals per boundary facet (CCW convention)."""
    e = mesh.boundary.edges
    v = mesh.vertices
    d = v[e[:, 1]] - v[e[:, 0]]
    lens = np.linalg.norm(d, axis=1)
    return np.stack([d[:, 1], -d[:, 0]], axis=1) / np.maximum(
        lens[:, None], 1e-300)


def save_mesh_visualization(mesh: MeshData, out_dir):
    """Write ``<prefix>_mesh.vtk``, ``<prefix>_<marker set>.vtk`` and
    ``normals/normals_<label>_id<id>.vtk`` under ``out_dir`` (prefix
    ``sulcus`` or ``rect``); returns ``out_dir``."""
    normals_dir = os.path.join(out_dir, "normals")
    os.makedirs(normals_dir, exist_ok=True)

    prefix = "sulcus" if mesh.domain_type == "sulcus" else "rect"
    write_vtk_mesh(os.path.join(out_dir, f"{prefix}_mesh.vtk"), mesh,
                   cell_data={"domain": mesh.cell_domain},
                   title="mesh + domain markers")

    marker_sets = {"bc_markers": mesh.bc_marker}
    if mesh.domain_type == "sulcus":
        marker_sets["bottom_markers"] = mesh.bottom_marker
        marker_sets["y0_markers"] = mesh.y0_marker
    for name, arr in marker_sets.items():
        _write_vtk_lines(os.path.join(out_dir, f"{prefix}_{name}.vtk"),
                         mesh.vertices, mesh.boundary.edges,
                         {"marker": arr}, name)

    normals = _facet_normals(mesh)
    edges = mesh.boundary.edges
    mids = 0.5 * (mesh.vertices[edges[:, 0]] + mesh.vertices[edges[:, 1]])
    id_to_name = {v: k for k, v in MARKERS.items()}
    for arr in marker_sets.values():
        for marker_id in np.unique(arr):
            if marker_id == 0:
                continue
            sel = arr == marker_id
            label = id_to_name.get(int(marker_id), str(marker_id))
            path = os.path.join(normals_dir,
                                f"normals_{label}_id{marker_id}.vtk")
            with open(path, "w") as f:
                f.write(f"# vtk DataFile Version 3.0\nnormals {label}\n"
                        "ASCII\nDATASET POLYDATA\n")
                f.write(f"POINTS {sel.sum()} double\n")
                _points(f, mids[sel])
                f.write(f"POINT_DATA {sel.sum()}\n")
                f.write("VECTORS normal double\n")
                _points(f, normals[sel])
    return out_dir

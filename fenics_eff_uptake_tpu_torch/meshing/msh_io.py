"""Gmsh MSH 2 (ASCII) reader and writer (counterpart of
``meshing/msh_io.py``): the mesh-ingestion contract.  A user holding the
reference's Gmsh artifacts can read the same triangulations; the writer
stores the port's own meshes (``run_simulation`` writes each run's
``Mesh Files/*.msh``).

Only what the study needs: 2-D nodes (z dropped), 3-node triangles
(element type 2); 2-node lines keep their physical tags.  The reader is
the C++ mesh kernel's parser (``native.read_msh2_native``), the port's
only one: a file it refuses raises.
"""

from __future__ import annotations

import os

from . import native
from .geometry import SulcusGeometry
from .markers import build_mesh_data
from .mesh_data import MeshData, orient_ccw

__all__ = ["read_msh2", "write_msh2", "mesh_from_msh2"]


def read_msh2(path):
    """Parse an ASCII MSH 2.x file: dict of vertices, triangles,
    triangle_tags, lines, line_tags and version (node ids remapped to
    0-based indices).  Raises ValueError on a file the parser refuses."""
    data = native.read_msh2_native(path)
    if data is None:
        raise ValueError(f"{path}: not an ASCII MSH 2.x triangle mesh the "
                         "parser accepts")
    return data


def write_msh2(path, vertices, cells):
    """Write an ASCII MSH 2.2 file (triangles only)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{len(vertices)}\n")
        for i, (x, y) in enumerate(vertices, start=1):
            f.write(f"{i} {x:.16g} {y:.16g} 0\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{len(cells)}\n")
        for i, c in enumerate(cells, start=1):
            f.write(f"{i} 2 2 0 1 {c[0] + 1} {c[1] + 1} {c[2] + 1}\n")
        f.write("$EndElements\n")


def mesh_from_msh2(path, geom: SulcusGeometry,
                   domain_type="sulcus") -> MeshData:
    """A MSH 2 triangulation marked with the reference's marker scheme
    (the geometry tells the marker predicates where the mouth and corners
    are)."""
    data = read_msh2(path)
    cells = orient_ccw(data["vertices"], data["triangles"])
    return build_mesh_data(data["vertices"], cells, geom, domain_type)

"""Legacy-VTK writers for ParaView (counterpart of ``utils/vtk.py``).

Plain ASCII legacy ``.vtk`` files that ParaView reads without a ``.pvd``
wrapper, byte for byte the JAX package's: coordinates and values as
``%.16g`` (which round-trips an f64), one triangle per ``CELLS`` line.
Field values are read through ``Function.as_numpy``, so a function whose
values lie on a CUDA device is written from a host copy.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["write_vtk_mesh", "write_vtk_point_scalar",
           "write_vtk_point_vector", "write_vtk_cell_scalar", "vertex_values"]


def _header(f, title):
    f.write("# vtk DataFile Version 3.0\n")
    f.write(f"{title}\n")
    f.write("ASCII\n")
    f.write("DATASET UNSTRUCTURED_GRID\n")


def _points(f, xy):
    """One ``x y 0`` line per row of the (n, 2) array ``xy``."""
    f.write("".join(f"{x:.16g} {y:.16g} 0\n"
                    for x, y in np.asarray(xy, dtype=float).tolist()))


def _scalars(f, values):
    f.write("".join(f"{v:.16g}\n"
                    for v in np.asarray(values, dtype=float).tolist()))


def _write_grid(f, vertices, cells):
    T = len(cells)
    f.write(f"POINTS {len(vertices)} double\n")
    _points(f, vertices)
    f.write(f"CELLS {T} {4 * T}\n")
    f.write("".join(f"3 {a} {b} {c}\n"
                    for a, b, c in np.asarray(cells).tolist()))
    f.write(f"CELL_TYPES {T}\n")
    f.write("5\n" * T)


def write_vtk_mesh(path, mesh, cell_data=None, title="mesh"):
    """The mesh as an unstructured grid, with optional per-cell scalars
    (``{name: (T,) array}``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        _header(f, title)
        _write_grid(f, mesh.vertices, mesh.cells)
        if cell_data:
            f.write(f"CELL_DATA {len(mesh.cells)}\n")
            for name, arr in cell_data.items():
                f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
                _scalars(f, arr)


def vertex_values(fn):
    """Vertex values of a P1/P2 Function: its first V scalar dofs (the
    vertices come first in both dof maps), as (V,) or, for a vector space
    with interleaved dofs, (V, 2)."""
    V = len(fn.space.mesh.vertices)
    vals = fn.as_numpy()
    if fn.space.vs == 1:
        return vals[:V]
    return np.stack([vals[0::2][:V], vals[1::2][:V]], axis=1)


def write_vtk_point_scalar(path, fn, name="c", title="field"):
    mesh = fn.space.mesh
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        _header(f, title)
        _write_grid(f, mesh.vertices, mesh.cells)
        f.write(f"POINT_DATA {len(mesh.vertices)}\n")
        f.write(f"SCALARS {name} double 1\nLOOKUP_TABLE default\n")
        _scalars(f, vertex_values(fn))


def write_vtk_point_vector(path, fn, name="u", title="field"):
    mesh = fn.space.mesh
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        _header(f, title)
        _write_grid(f, mesh.vertices, mesh.cells)
        f.write(f"POINT_DATA {len(mesh.vertices)}\n")
        f.write(f"VECTORS {name} double\n")
        _points(f, vertex_values(fn))


def write_vtk_cell_scalar(path, mesh, arr, name="marker", title="markers"):
    write_vtk_mesh(path, mesh, cell_data={name: arr}, title=title)

"""Mass and region-average metrics of one run (counterpart of
``analysis/mass.py``); the keys are the reference's."""

from __future__ import annotations

from ..fem.space import Function
from ..meshing.mesh_data import MeshData
from .facets import as_values
from .integrals import integrate_cells

__all__ = ["compute_mass_metrics"]


def compute_mass_metrics(c: Function, mesh: MeshData, domain_type,
                         degree=4):
    """Total and per-region mass, areas and average concentrations."""
    per_cell = integrate_cells(c, degree).cpu().numpy()
    ones = Function(c.space, as_values(c.values) * 0 + 1.0)
    area_cell = integrate_cells(ones, degree).cpu().numpy()
    total_mass = float(per_cell.sum())
    total_area = float(area_cell.sum())
    if domain_type != "sulcus":
        return {
            "total_mass": total_mass,
            "total_area": total_area,
            "average_concentration": (total_mass / total_area
                                      if total_area else 0.0),
        }
    sulc = mesh.cell_domain == 1
    rect = mesh.cell_domain == 2
    sulcus_mass = float(per_cell[sulc].sum())
    rectangle_mass = float(per_cell[rect].sum())
    sulcus_area = float(area_cell[sulc].sum())
    rect_area = float(area_cell[rect].sum())
    return {
        "total_mass": total_mass,
        "sulcus_mass": sulcus_mass,
        "rectangle_mass": rectangle_mass,
        "total_area": total_area,
        "sulcus_area": sulcus_area,
        "rectangle_area": rect_area,
        "average_concentration": {
            "total": total_mass / total_area if total_area > 0 else None,
            "sulcus_region": (sulcus_mass / sulcus_area
                              if sulcus_area > 0 else None),
            "rectangle_region": (rectangle_mass / rect_area
                                 if rect_area > 0 else None),
        },
    }

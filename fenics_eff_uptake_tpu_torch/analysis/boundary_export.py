"""Per-facet boundary flux export, physical against Robin (counterpart of
``analysis/boundary_export.py``).

The facet-averaged physical flux -D grad(c) . n (+ (u . n) c) and Robin
flux mu c along a marked boundary, written as a CSV profile (columns x,
physical_flux, robin_flux, length; floats at full precision, through
``studies.common.save_csv``, as the JAX package's pandas writer) and a
legacy-VTK polyline with both as point data.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..meshing.mesh_data import MARKERS, MeshData
from .facets import as_values
from .flux import boundary_quad

__all__ = ["export_boundary_flux_comparison"]


def export_boundary_flux_comparison(c, mu, D, mesh: MeshData, output_dir,
                                    marker_id=None, u=None):
    """Write ``boundary_flux_comparison.csv`` and ``flux_bottom.vtk`` under
    ``output_dir``; returns the per-facet arrays sorted by midpoint x (x,
    physical, robin), or None where the boundary has no facets."""
    from ..studies.common import save_csv
    if marker_id is None:
        marker_id = MARKERS["bottom"]
    fq = boundary_quad(c.space, mesh.bc_marker == marker_id, degree=4)
    if fq is None:
        return None
    cv = as_values(c.values)
    n = torch.as_tensor(fq.normal, device=cv.device)
    phys_density = -D * torch.einsum("fqa,fa->fq", fq.eval_grad(cv), n)
    cq = fq.eval(cv)
    if u is not None:
        un = np.einsum("fqa,fa->fq", fq.eval_vector(u.values, u.space),
                       fq.normal)
        phys_density = phys_density + torch.as_tensor(un,
                                                      device=cv.device) * cq
    if np.isscalar(mu):
        mu_q = float(mu) * cq
    else:
        mu_q = torch.as_tensor(np.asarray(mu(fq.x[:, :, 0]),
                                          dtype=np.float64),
                               device=cv.device) * cq
    qw = torch.as_tensor(fq.qw, device=cv.device)
    phys = torch.einsum("q,fq->f", qw, phys_density).cpu().numpy()
    robin = torch.einsum("q,fq->f", qw, mu_q).cpu().numpy()
    xmid = fq.x.mean(axis=1)[:, 0]
    order = np.argsort(xmid)

    os.makedirs(output_dir, exist_ok=True)
    save_csv([{"x": float(x), "physical_flux": float(p),
               "robin_flux": float(r), "length": float(ln)}
              for x, p, r, ln in zip(xmid[order], phys[order], robin[order],
                                     np.asarray(fq.length)[order])],
             os.path.join(output_dir, "boundary_flux_comparison.csv"))

    pts = fq.x.mean(axis=1)[order]
    with open(os.path.join(output_dir, "flux_bottom.vtk"), "w") as f:
        f.write("# vtk DataFile Version 3.0\nboundary flux\nASCII\n")
        f.write("DATASET POLYDATA\n")
        f.write(f"POINTS {len(pts)} double\n")
        for x, y in pts:
            f.write(f"{x:.16g} {y:.16g} 0\n")
        f.write(f"POINT_DATA {len(pts)}\n")
        f.write("SCALARS physical_flux double 1\nLOOKUP_TABLE default\n")
        for v in phys[order]:
            f.write(f"{v:.16g}\n")
        f.write("SCALARS robin_flux double 1\nLOOKUP_TABLE default\n")
        for v in robin[order]:
            f.write(f"{v:.16g}\n")
    return {"x": xmid[order], "physical": phys[order],
            "robin": robin[order]}

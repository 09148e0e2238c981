"""Boundary and interface flux metrics (counterpart of
``analysis/flux.py``): the physical flux J = -D grad(c) . n + (u . n) c
per boundary, the Robin uptake flux mu c, the sulcus segment fluxes, the
interior mouth flux through the channel-side trace, its exchange metrics,
and the y0_flux / y0_combined identity check.  Output dicts match the
reference's JSON schema key for key.

The facet sets (``boundary_quad``, ``mouth_quad``) are shared with the
batched metrics (``analysis/batched_metrics.py``), which evaluate the same
integrals for all columns of a sweep at once; the functions below are the
per-run forms, for one concentration c (a ``Function`` whose values are a
tensor on any device, or numpy) and an optional velocity u.  They compute
in f64 on c's device (u . n is formed on the host) and return floats.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..fem.space import FunctionSpace
from ..meshing.mesh_data import MARKERS, MeshData
from .facets import FacetQuad, as_values, build_facet_quad

__all__ = [
    "physical_flux_facets", "compute_physical_flux_boundary",
    "compute_sulcus_segment_fluxes", "compute_uptake_flux_bottom",
    "compute_uptake_flux_segments", "compute_flux_metrics",
    "boundary_quad", "mouth_quad",
]


def boundary_quad(space: FunctionSpace, facet_mask,
                  degree=4) -> Optional[FacetQuad]:
    sel = np.flatnonzero(facet_mask)
    if len(sel) == 0:
        return None
    fs = space.mesh.boundary
    return build_facet_quad(space, fs.cell[sel], fs.local_edge[sel],
                            degree=degree)


def mouth_quad(space: FunctionSpace, degree=4) -> Optional[FacetQuad]:
    """Interior y = 0 mouth facets on the channel ('+') side; the normal
    points into the cavity (the reference's rectangle-side trace)."""
    iy = space.mesh.interior_y0
    if iy is None or len(iy) == 0:
        return None
    return build_facet_quad(space, iy.cell_plus, iy.local_edge_plus,
                            degree=degree)


def _densities(fq: FacetQuad, c, u, D):
    """(diffusive, advective or None) flux densities (F, Q) at the facet
    quadrature points, f64 on c's device."""
    cv = as_values(c.values)
    n = torch.as_tensor(fq.normal, device=cv.device)
    diff = -D * torch.einsum("fqa,fa->fq", fq.eval_grad(cv), n)
    if u is None:
        return diff, None
    un = np.einsum("fqa,fa->fq", fq.eval_vector(u.values, u.space),
                   fq.normal)
    return diff, torch.as_tensor(un, device=cv.device) * fq.eval(cv)


def physical_flux_facets(fq: FacetQuad, c, u, D):
    """(diffusive, advective) flux integrals over the facet set:
    int -D grad(c) . n ds and int (u . n) c ds."""
    diff, adv = _densities(fq, c, u, D)
    return (float(fq.integrate(diff)),
            0.0 if adv is None else float(fq.integrate(adv)))


def _flux_dict(d, a):
    return {"diffusive": d, "advective": a, "total": d + a}


def compute_physical_flux_boundary(c, u, mesh: MeshData, marker_id, D,
                                   degree=4):
    """Physical flux across one bc-marked boundary."""
    fq = boundary_quad(c.space, mesh.bc_marker == marker_id, degree)
    if fq is None:
        return _flux_dict(0.0, 0.0)
    return _flux_dict(*physical_flux_facets(fq, c, u, D))


def compute_sulcus_segment_fluxes(c, u, mesh: MeshData, D, degree=4,
                                  warn=True):
    """The sulcus flux bookkeeping: bottom_left / sulcus / bottom_right /
    sulcus_opening / sulcus_opening_extra / y0_flux / bottom_combined /
    y0_combined, and ``_y0_identity_gap``."""
    fluxes = {}
    for name in ("bottom_left", "sulcus", "bottom_right"):
        fq = boundary_quad(c.space, mesh.bottom_marker == MARKERS[name],
                           degree)
        fluxes[name] = (_flux_dict(0.0, 0.0) if fq is None
                        else _flux_dict(*physical_flux_facets(fq, c, u, D)))

    # the interior mouth, channel-side trace
    mq = mouth_quad(c.space, degree)
    if mq is not None:
        diff, adv = _densities(mq, c, u, D)
        J_open_diff = float(mq.integrate(diff))
        J_open_adv = 0.0 if adv is None else float(mq.integrate(adv))
        q_open = diff if adv is None else diff + adv
        E_L1 = float(mq.integrate(q_open.abs()))
        Q_in = float(mq.integrate(q_open.clamp(min=0.0)))
        Q_out = float(mq.integrate((-q_open).clamp(min=0.0)))
        L_sig = mq.total_length
    else:
        J_open_diff = J_open_adv = E_L1 = Q_in = Q_out = L_sig = 0.0
    fluxes["sulcus_opening"] = _flux_dict(J_open_diff, J_open_adv)
    fluxes["sulcus_opening_extra"] = {
        "E_L1": E_L1,
        "E_avg": E_L1 / L_sig if L_sig > 0 else 0.0,
        "Q_in": Q_in,
        "Q_out": Q_out,
        "net_check": Q_in - Q_out,
        "length": L_sig,
    }

    # the whole y = 0 line: its exterior (flat) facets and the mouth
    fq_y0 = boundary_quad(c.space, mesh.y0_marker == MARKERS["y0_line"],
                          degree)
    d_ext, a_ext = ((0.0, 0.0) if fq_y0 is None
                    else physical_flux_facets(fq_y0, c, u, D))
    fluxes["y0_flux"] = {
        "diffusive": d_ext + J_open_diff,
        "advective": a_ext + J_open_adv,
        "total": d_ext + J_open_diff + a_ext + J_open_adv,
    }

    def _sum(keys):
        return {f: sum(fluxes[k][f] for k in keys)
                for f in ("diffusive", "advective", "total")}

    fluxes["bottom_combined"] = _sum(["bottom_left", "sulcus",
                                      "bottom_right"])
    fluxes["y0_combined"] = _sum(["bottom_left", "bottom_right",
                                  "sulcus_opening"])
    # y0_combined misses the corner-adjacent flat facets that the strict
    # inequalities of markers 5 and 7 exclude (as in the reference): the
    # gap is reported, not asserted
    gap = abs(fluxes["y0_flux"]["total"] - fluxes["y0_combined"]["total"])
    fluxes["_y0_identity_gap"] = gap
    if warn and gap > 1e-10:
        print(f"y0_flux vs y0_combined differ by {gap:.3e} "
              "(corner-facet marker exclusion; matches reference behaviour)")
    return fluxes


def _uptake(fq: FacetQuad, c, mu):
    """int mu c ds over the facet set; mu a number or a vectorised
    callable of x."""
    cq = fq.eval(c.values)
    if np.isscalar(mu):
        return float(mu) * float(fq.integrate(cq))
    mu_q = torch.as_tensor(np.asarray(mu(fq.x[:, :, 0]), dtype=np.float64),
                           device=cq.device)
    return float(fq.integrate(mu_q * cq))


def compute_uptake_flux_bottom(c, mesh: MeshData, mu, degree=4):
    """int mu c ds over the whole bottom wall (marker 4)."""
    fq = boundary_quad(c.space, mesh.bc_marker == MARKERS["bottom"], degree)
    return 0.0 if fq is None else _uptake(fq, c, mu)


def compute_uptake_flux_segments(c, mesh: MeshData, mu, degree=4):
    """The Robin uptake flux per bottom segment and their total."""
    out = {}
    total = 0.0
    for name in ("bottom_left", "sulcus", "bottom_right"):
        fq = boundary_quad(c.space, mesh.bottom_marker == MARKERS[name],
                           degree)
        out[name] = 0.0 if fq is None else _uptake(fq, c, mu)
        total += out[name]
    out["total"] = total
    return out


def compute_flux_metrics(c, u, mesh: MeshData, domain_type, D, mu,
                         degree=4, warn=True):
    """The top-level flux metrics dict of one run."""
    metrics = {
        "physical_flux": {
            name: compute_physical_flux_boundary(
                c, u, mesh, MARKERS[name], D, degree)
            for name in ("left", "right", "top", "bottom")
        },
        "uptake_flux": compute_uptake_flux_bottom(c, mesh, mu, degree),
    }
    if domain_type == "sulcus":
        metrics["sulcus_specific"] = {
            "physical_flux": compute_sulcus_segment_fluxes(
                c, u, mesh, D, degree, warn=warn),
            "uptake_flux": compute_uptake_flux_segments(c, mesh, mu, degree),
        }
    return metrics

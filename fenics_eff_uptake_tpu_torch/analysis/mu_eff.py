"""The mu_eff engine (counterpart of ``analysis/mu_eff.py``): four
estimators of the effective uptake coefficient of a flat surrogate wall,

  arc : mu * (1 + (L_arc - w) / L), L_arc the sine-curve arc length
  enh : mu * ((L - w)/L + (w/L) / sqrt(1 + kappa mu h^2 / w)), kappa = 10
  sim : J_y0 / int_{y0} c ds, the y0 line's concentration = its exterior
        flat part + the channel-side mouth trace
  open: J_mouth / int_mouth c ds on the mouth alone

and the bottom-wall mu(x) sampler.  ``compute_mu_eff_metrics`` is the
per-run form; the sweeps take the same numbers from
``analysis/batched_metrics.py``.
"""

from __future__ import annotations

import numpy as np

from ..fem.quadrature import gauss_legendre_01
from ..meshing.mesh_data import MARKERS, MeshData
from .flux import boundary_quad, mouth_quad

__all__ = ["sulcus_arc_length", "compute_mu_eff_arc", "compute_mu_eff_enh",
           "compute_concentration_profiles", "compute_mu_eff_sim",
           "compute_mu_eff_sim_mouth", "compute_mu_eff_metrics",
           "sample_mu_along_bottom"]


def sulcus_arc_length(w, h, panels=32, order=10):
    """w * int_0^1 sqrt(1 + (pi h / w cos(pi u))^2) du, composite GL."""
    t0, w0 = gauss_legendre_01(order)
    edges = np.linspace(0.0, 1.0, panels + 1)
    total = 0.0
    for a, b in zip(edges[:-1], edges[1:]):
        u = a + (b - a) * t0
        total += (b - a) * np.sum(
            w0 * np.sqrt(1.0 + (np.pi * h / w * np.cos(np.pi * u)) ** 2))
    return w * total


def compute_mu_eff_arc(params):
    L, h, w = float(params.L), float(params.sulci_h), float(params.sulci_w)
    mu = float(params.mu)
    if w <= 0 or h <= 0 or L <= 0:
        return None
    return float(mu * (1.0 + (sulcus_arc_length(w, h) - w) / L))


def compute_mu_eff_enh(params, kappa=10.0):
    L, h, w = float(params.L), float(params.sulci_h), float(params.sulci_w)
    mu = float(params.mu)
    if L <= 0 or mu < 0 or w <= 0:
        return None
    f = 1.0 / np.sqrt(1.0 + kappa * mu * h ** 2 / w)
    return float(mu * ((L - w) / L + (w / L) * f))


def compute_concentration_profiles(c, mesh: MeshData, degree=4):
    """Line integrals of c along y = 0: C_y0_ext over the exterior flat
    facets (marker 10), C_mouth through the channel-side trace of the
    interior mouth facets, their lengths and means."""
    fq_ext = boundary_quad(c.space, mesh.y0_marker == MARKERS["y0_line"],
                           degree)
    C_y0_ext = (float(fq_ext.integrate(fq_ext.eval(c.values)))
                if fq_ext else 0.0)
    L_y0_ext = fq_ext.total_length if fq_ext else 0.0
    mq = mouth_quad(c.space, degree)
    C_mouth = float(mq.integrate(mq.eval(c.values))) if mq else 0.0
    L_mouth = mq.total_length if mq else 0.0
    C_y0_total = C_y0_ext + C_mouth
    L_total = L_y0_ext + L_mouth
    return {
        "C_y0_ext": C_y0_ext,
        "C_mouth": C_mouth,
        "C_y0_total": C_y0_total,
        "lengths": {"L_y0_ext": L_y0_ext, "L_mouth": L_mouth,
                    "L_y0_total": L_total},
        "means": {
            "mean_y0_ext": C_y0_ext / L_y0_ext if L_y0_ext > 0 else np.nan,
            "mean_mouth": C_mouth / L_mouth if L_mouth > 0 else np.nan,
            "mean_y0_total": C_y0_total / L_total if L_total > 0 else np.nan,
        },
    }


def _flux_from_dict(pf, keys):
    for k in keys:
        if k in pf and "total" in pf[k]:
            return float(pf[k]["total"])
    return None


def compute_mu_eff_sim(flux_metrics, conc):
    """mu_eff^sim = J_y0 / C_y0_total, None where C_y0_total <= 0."""
    C_y0 = conc["C_y0_total"]
    if not np.isfinite(C_y0) or C_y0 <= 0.0:
        return None
    pf = flux_metrics.get("sulcus_specific", {}).get("physical_flux", {})
    J_y0 = _flux_from_dict(pf, ("y0_flux", "y0_combined"))
    return None if J_y0 is None else float(J_y0 / C_y0)


def compute_mu_eff_sim_mouth(flux_metrics, conc):
    """mu_eff^open = J_mouth / C_mouth, None where C_mouth <= 0."""
    C_sigma = conc["C_mouth"]
    if not np.isfinite(C_sigma) or C_sigma <= 0.0:
        return None
    pf = flux_metrics.get("sulcus_specific", {}).get("physical_flux", {})
    J_sigma = _flux_from_dict(
        pf, ("opening", "mouth", "y0_opening", "y0_mouth", "sulcus_opening"))
    return None if J_sigma is None else float(J_sigma / C_sigma)


def compute_mu_eff_metrics(c, mesh: MeshData, params, flux_metrics,
                           kappa=10.0, degree=4):
    """The four estimators with their ratios to mu, their errors against
    sim (percent) and the audit of the line integrals and fluxes."""
    mu = float(params.mu) if np.isscalar(params.mu) else None
    conc = compute_concentration_profiles(c, mesh, degree)
    mu_eff_arc = compute_mu_eff_arc(params)
    mu_eff_enh = compute_mu_eff_enh(params, kappa=kappa)
    mu_eff_sim = compute_mu_eff_sim(flux_metrics, conc)
    mu_eff_open = compute_mu_eff_sim_mouth(flux_metrics, conc)

    def _ratio(x, y):
        return (float(x / y) if (x is not None and y not in (None, 0.0))
                else None)

    def _pct_err(approx, truth):
        if truth in (None, 0.0) or approx is None:
            return None
        return float(abs(approx - truth) / abs(truth) * 100.0)

    pf = flux_metrics.get("sulcus_specific", {}).get("physical_flux", {})
    return {
        "mu_eff_arc": mu_eff_arc,
        "mu_eff_enh": mu_eff_enh,
        "mu_eff_sim": mu_eff_sim,
        "mu_eff_open": mu_eff_open,
        "ratios": {"arc": _ratio(mu_eff_arc, mu),
                   "enh": _ratio(mu_eff_enh, mu),
                   "sim": _ratio(mu_eff_sim, mu),
                   "open": _ratio(mu_eff_open, mu)},
        "errors_vs_sim": {"arc": _pct_err(mu_eff_arc, mu_eff_sim),
                          "enh": _pct_err(mu_eff_enh, mu_eff_sim),
                          "open": _pct_err(mu_eff_open, mu_eff_sim)},
        "audit": {
            "concentrations": {k: conc[k] for k in
                               ("C_y0_ext", "C_mouth", "C_y0_total")},
            "lengths": conc["lengths"],
            "means": conc["means"],
            "fluxes": {
                "J_y0_total": _flux_from_dict(pf, ("y0_flux",
                                                   "y0_combined")),
                "J_sigma_mouth": _flux_from_dict(pf, ("sulcus_opening",)),
            },
        },
    }


def sample_mu_along_bottom(params, mesh, n_points=500, save_csv_path=None):
    """mu(x) on ``n_points`` equispaced x over the mesh's extent: a scalar
    ``params.mu`` repeated, a callable evaluated.  Returns the arrays ``x``
    and ``mu`` and the scalars ``mu_mean`` (trapezoid rule over the
    extent), ``mu_min``, ``mu_max``; ``save_csv_path``: also write the
    columns x, mu there."""
    mu_obj = params.mu
    xs = np.linspace(float(mesh.vertices[:, 0].min()),
                     float(mesh.vertices[:, 0].max()), int(n_points))
    if np.isscalar(mu_obj):
        mus = np.full_like(xs, float(mu_obj))
    else:
        mus = np.asarray(mu_obj(xs), dtype=np.float64)
    if len(xs) > 1:
        mean = float(np.sum(0.5 * (mus[1:] + mus[:-1]) * np.diff(xs))
                     / (xs[-1] - xs[0]))
    else:
        mean = float(mus.mean())
    if save_csv_path:
        from ..studies.common import save_csv
        save_csv([{"x": float(x), "mu": float(m)} for x, m in zip(xs, mus)],
                 save_csv_path)
    return {"x": xs, "mu": mus, "mu_mean": mean,
            "mu_min": float(mus.min()), "mu_max": float(mus.max())}

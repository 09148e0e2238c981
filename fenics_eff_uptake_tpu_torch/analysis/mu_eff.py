"""Closed-form mu_eff estimators and the bottom-wall mu(x) sampler (from
the JAX package's ``analysis/mu_eff.py``, whose module imports jax):

  arc : mu * (1 + (L_arc - w) / L), L_arc the sine-curve arc length
  enh : mu * ((L - w)/L + (w/L) / sqrt(1 + kappa mu h^2 / w)), kappa = 10
"""

from __future__ import annotations

import numpy as np

from ..fem.quadrature import gauss_legendre_01

__all__ = ["sulcus_arc_length", "compute_mu_eff_arc", "compute_mu_eff_enh",
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


def sample_mu_along_bottom(params, mesh, n_points=500):
    """mu(x) on ``n_points`` equispaced x over the mesh's extent: a scalar
    ``params.mu`` repeated, a callable evaluated.  Returns the arrays ``x``
    and ``mu`` and the scalars ``mu_mean`` (trapezoid rule over the
    extent), ``mu_min``, ``mu_max``."""
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
    return {"x": xs, "mu": mus, "mu_mean": mean,
            "mu_min": float(mus.min()), "mu_max": float(mus.max())}

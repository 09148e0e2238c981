"""Quadrature rules for triangles and 1-D facets.

Replaces the FFC-selected quadrature behind every dolfin ``assemble`` in the
reference (solvers.py, analysis.py).  All rules are symmetric Gauss rules on
the reference triangle T = {(x,y): x>=0, y>=0, x+y<=1} (area 1/2) and
Gauss-Legendre on the reference interval [0,1].

Tables are plain NumPy (the port's copy of the JAX package's
``fem/quadrature.py``), so precision and determinism are exact.
"""

from __future__ import annotations

import numpy as np

__all__ = ["triangle_rule", "interval_rule", "gauss_legendre_01"]


def gauss_legendre_01(n: int):
    """n-point Gauss-Legendre rule on [0, 1]; returns (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def interval_rule(degree: int):
    """Gauss rule on [0,1] exact for polynomials up to ``degree``."""
    n = max(1, (degree + 2) // 2)
    return gauss_legendre_01(n)


# Symmetric triangle rules. Weights sum to 1/2 (reference-triangle area).
def _dunavant(points_bary, weights):
    pts = np.asarray(points_bary, dtype=np.float64)[:, 1:]  # (L2,L3)->(x,y)
    w = np.asarray(weights, dtype=np.float64) * 0.5
    return pts, w


def triangle_rule(degree: int):
    """Symmetric quadrature on the reference triangle, exact to ``degree``.

    Returns (points (Q,2), weights (Q,)) with sum(weights) = 1/2.
    Rules: degree 1 (1pt), 2 (3pt), 3 (4pt), 4 (6pt), 5 (7pt), 6 (12pt).
    """
    if degree <= 1:
        return _dunavant([[1 / 3, 1 / 3, 1 / 3]], [1.0])
    if degree == 2:
        a = 1 / 6
        return _dunavant(
            [[2 / 3, a, a], [a, 2 / 3, a], [a, a, 2 / 3]],
            [1 / 3, 1 / 3, 1 / 3])
    if degree == 3:
        return _dunavant(
            [[1 / 3, 1 / 3, 1 / 3],
             [0.6, 0.2, 0.2], [0.2, 0.6, 0.2], [0.2, 0.2, 0.6]],
            [-27 / 48, 25 / 48, 25 / 48, 25 / 48])
    if degree == 4:
        a1, b1 = 0.108103018168070, 0.445948490915965
        a2, b2 = 0.816847572980459, 0.091576213509771
        w1, w2 = 0.223381589678011, 0.109951743655322
        return _dunavant(
            [[a1, b1, b1], [b1, a1, b1], [b1, b1, a1],
             [a2, b2, b2], [b2, a2, b2], [b2, b2, a2]],
            [w1, w1, w1, w2, w2, w2])
    if degree == 5:
        a1, b1 = 0.059715871789770, 0.470142064105115
        a2, b2 = 0.797426985353087, 0.101286507323456
        w0 = 0.225
        w1 = 0.132394152788506
        w2 = 0.125939180544827
        return _dunavant(
            [[1 / 3, 1 / 3, 1 / 3],
             [a1, b1, b1], [b1, a1, b1], [b1, b1, a1],
             [a2, b2, b2], [b2, a2, b2], [b2, b2, a2]],
            [w0, w1, w1, w1, w2, w2, w2])
    # degree 6: 12-point Dunavant
    a1, b1 = 0.873821971016996, 0.063089014491502
    a2, b2 = 0.501426509658179, 0.249286745170910
    a3, b3, c3 = 0.636502499121399, 0.310352451033785, 0.053145049844816
    w1 = 0.050844906370207
    w2 = 0.116786275726379
    w3 = 0.082851075618374
    pts = [
        [a1, b1, b1], [b1, a1, b1], [b1, b1, a1],
        [a2, b2, b2], [b2, a2, b2], [b2, b2, a2],
        [a3, b3, c3], [a3, c3, b3], [b3, a3, c3],
        [b3, c3, a3], [c3, a3, b3], [c3, b3, a3],
    ]
    ws = [w1, w1, w1, w2, w2, w2, w3, w3, w3, w3, w3, w3]
    return _dunavant(pts, ws)

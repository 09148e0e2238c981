"""Facet sets of the flux metrics (counterpart of ``analysis/flux.py``):
boundary facets by marker and the interior mouth facets, channel side.
The integrals themselves run batched in ``analysis/batched_metrics.py``."""

from __future__ import annotations

from typing import Optional

import numpy as np

from fenics_eff_uptake_tpu.fem.space import FunctionSpace

from .facets import FacetQuad, build_facet_quad

__all__ = ["boundary_quad", "mouth_quad"]


def boundary_quad(space: FunctionSpace, facet_mask,
                  degree) -> Optional[FacetQuad]:
    sel = np.flatnonzero(facet_mask)
    if len(sel) == 0:
        return None
    fs = space.mesh.boundary
    return build_facet_quad(space, fs.cell[sel], fs.local_edge[sel],
                            degree=degree)


def mouth_quad(space: FunctionSpace, degree) -> Optional[FacetQuad]:
    """Interior y = 0 mouth facets on the channel ('+') side; the normal
    points into the cavity (the reference's rectangle-side trace)."""
    iy = space.mesh.interior_y0
    if iy is None or len(iy) == 0:
        return None
    return build_facet_quad(space, iy.cell_plus, iy.local_edge_plus,
                            degree=degree)

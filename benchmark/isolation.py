"""The isolation check: no module loaded whose top-level name (the part
before the first dot, compared whole) is JAX's or the JAX package's.  The
port's own name begins with the JAX package's, so a prefix match would be
wrong."""

from __future__ import annotations

import sys

__all__ = ["FORBIDDEN", "loaded", "REFERENCE_FORBIDDEN"]

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fenics_eff_uptake_tpu"})
# what the plain reference may not load besides
REFERENCE_FORBIDDEN = FORBIDDEN | {"fenics_eff_uptake_tpu_torch"}


def loaded(forbidden=FORBIDDEN, modules=None):
    """The sorted top-level names in ``forbidden`` among ``modules``
    (default: ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(forbidden))

"""Modules a run of the port may not load: JAX and the JAX package. A
module counts by its top-level name (before the first dot), compared
whole, so the port, whose name begins with the JAX package's, passes."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpustomp"})


def forbidden_loaded(modules=None) -> list:
    """The forbidden top-level names among `modules` (sys.modules)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)

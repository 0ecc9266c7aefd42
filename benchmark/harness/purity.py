"""The run must not load JAX or the JAX package.  Module names are compared
by their top-level name, whole: ``vicalib_tpu_torch`` begins with the JAX
package's name and is not it."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "vicalib_tpu"})


def forbidden_modules(modules=None):
    """Sorted top-level names in ``modules`` (default: sys.modules) that
    are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)

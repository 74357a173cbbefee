"""The check that a run loaded nothing of JAX or of the JAX package: the
top-level name of every module in ``sys.modules`` (the part before the
first dot), compared whole.  ``gaussianhaircut_torch`` begins with the JAX
package's name and is not it."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "gaussianhaircut_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)

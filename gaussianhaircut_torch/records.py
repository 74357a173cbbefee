"""``TensorRecord``: a dataclass of same-role tensors (parameters, their
gradients, Adam moments, learning rates) with the field-wise helpers that the
JAX package gets from ``jax.tree.map``."""
from __future__ import annotations

import dataclasses


class TensorRecord:
    """Mixin for dataclasses whose fields are all tensors (or scalars)."""

    @classmethod
    def names(cls) -> tuple[str, ...]:
        return tuple(f.name for f in dataclasses.fields(cls))

    def values(self) -> list:
        return [getattr(self, n) for n in self.names()]

    def map(self, fn, *others):
        """New record of ``fn(self.f, other1.f, ...)`` for every field f."""
        return type(self)(**{n: fn(getattr(self, n), *(getattr(o, n) for o in others))
                             for n in self.names()})

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

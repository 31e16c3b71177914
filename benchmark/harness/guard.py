"""The import guard: no process of a run may hold the JAX package or
JAX, compared by the whole top-level name of each loaded module (the
port's name begins with the JAX package's)."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "libsplinter_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names}
                  & FORBIDDEN)

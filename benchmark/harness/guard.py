"""The run must not have loaded JAX or the JAX package: top-level module
names compared whole (the port's name begins with the JAX package's)."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "ltm")


def forbidden_modules(names: Iterable[str]) -> List[str]:
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})

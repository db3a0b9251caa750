"""The run's check that neither JAX nor the JAX package was loaded.

Modules are compared by their whole top-level name (the part before the
first dot): ``jsplayer_tpu_torch`` begins with ``jsplayer_tpu`` and is
not it.
"""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "jsplayer_tpu")


def forbidden(modules=None) -> list:
    """The forbidden top-level names among `modules` (sys.modules when
    None)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))

"""The check that a run holds nothing of JAX: the top-level name of every
module in `sys.modules`, compared whole (the port's name, `signerf_tpu_torch`,
begins with the JAX package's)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "signerf_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names this process holds, sorted."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))

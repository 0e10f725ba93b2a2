"""The modules a run must not hold: the JAX stack and the JAX package.

Names are compared by their top-level part (before the first dot) as a
whole, so the port ``aligner_tpu_torch`` is not the JAX package
``aligner_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "aligner_tpu"})
# what the reference may not use besides: anything of the program
PROGRAM = "aligner_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_loaded(modules=None) -> list[str]:
    """Top-level names of ``modules`` (default ``sys.modules``) that are
    forbidden in a run."""
    names = sys.modules if modules is None else modules
    return sorted({top(n) for n in names if top(n) in FORBIDDEN})


def quiet_environment(env) -> None:
    """Keep libraries that would load JAX by themselves from doing so."""
    env.setdefault("USE_FLAX", "0")
    env.setdefault("USE_JAX", "0")
    env.setdefault("USE_TORCH", "1")

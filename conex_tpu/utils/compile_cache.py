"""Persistent compilation cache for the repository's scripts.

``chip_smoke.py``, ``bench.py`` and the scripts under ``benchmarks/`` call
``enable_compile_cache()`` before they compile anything.  The library itself
(``Program.solve`` and friends) never sets a cache: that is the caller's
choice.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Return the directory JAX keeps its compiled programs in.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing else is set.  Otherwise the cache goes to the fixed
    ``<checkout>/.jax_cache``, so the next run from the same checkout finds
    what this one compiled (a temporary or per-process directory never
    would).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path

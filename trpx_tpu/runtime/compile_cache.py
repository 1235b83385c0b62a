"""JAX's persistent compilation cache, placed in one way for every entry
point (CLI, bench.py, chip_smoke.py).

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
directory is set here. Otherwise the cache lives at ``<checkout>/.jax_cache``
beside the package: a fixed path, because the directory is part of what
makes a later process find an entry again. ``TRPX_JAX_CACHE=0`` turns the
cache off (the test suite does, so that no test leaves it on for the next).
"""

from __future__ import annotations

import os
from pathlib import Path

#: the cache directory used when JAX_COMPILATION_CACHE_DIR is unset
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str | None:
    """Turn the persistent compilation cache on before the first compile.
    Returns the directory in use, or None when ``TRPX_JAX_CACHE=0``."""
    if os.environ.get("TRPX_JAX_CACHE") == "0":
        return None
    import jax

    cache = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache:
        cache = str(DEFAULT_DIR)
        jax.config.update("jax_compilation_cache_dir", cache)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return cache

"""Where the persistent XLA compile cache lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, that directory is used and no
other is set in code; otherwise the cache goes to ``.jax_cache`` at the
root of this checkout, resolved from this module's own path. Compiled
programs shorter than ``MIN_COMPILE_SECS`` to build are not cached.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = pathlib.Path(__file__).resolve().parents[1]
MIN_COMPILE_SECS = 2.0


def cache_dir() -> str:
    return os.environ.get(ENV_VAR) or str(CHECKOUT / ".jax_cache")


def enable() -> str:
    """Point JAX's persistent compile cache at `cache_dir`; returns it."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      MIN_COMPILE_SECS)
    return path

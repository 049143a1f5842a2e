"""JAX's persistent compilation cache at a fixed directory."""

from __future__ import annotations

import os


def enable_compile_cache(default_dir: str) -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own
    and nothing is set here. Otherwise the cache goes to
    ``default_dir``, which callers keep at a fixed path inside the
    checkout so that every run of the same program finds the entries
    of the one before.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir

"""JAX persistent compile cache: one place that decides its directory.

Every script that enables the cache calls :func:`enable_compile_cache`.
If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it on its own and
nothing is set in code.  Otherwise the cache lives at the fixed path
``<repo>/.jax_cache`` (listed in ``.gitignore``): the path is part of
the cache key, so a directory that moved would never hit.
"""
from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Enable the persistent compile cache; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

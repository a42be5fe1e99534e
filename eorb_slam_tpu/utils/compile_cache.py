"""JAX's persistent compile cache, at one fixed place.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
is set here. Otherwise the cache lives in ``<repo>/.jax_cache`` (listed in
``.gitignore``): a fixed path, since the path is part of the cache key.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"


def default_dir() -> str:
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def enable() -> str:
    """Turn the cache on; returns the directory in force."""
    env = os.environ.get(ENV)
    if env:
        return env
    import jax

    path = default_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path

"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache goes to ``<checkout>/.jax_cache``,
a fixed path (the path is part of the cache key, so a moving directory
never hits), listed in ``.gitignore``.
"""

from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory."""
    env = os.environ.get(ENV)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

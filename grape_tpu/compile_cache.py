"""JAX's persistent compilation cache for this checkout.

The cache directory is part of the cache's key, so it must not move
between runs: where ``JAX_COMPILATION_CACHE_DIR`` is set, that directory
is used; otherwise ``<checkout>/.jax_cache`` (listed in ``.gitignore``),
derived from this file's location.
"""

import os

import jax

__all__ = ["enable_compile_cache", "default_cache_dir"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir():
    """``<checkout>/.jax_cache`` for the checkout holding this package."""
    checkout = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(checkout, ".jax_cache")


def enable_compile_cache():
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory.  Call before the first
    compilation of the process."""
    path = os.environ.get(ENV_VAR) or default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path

"""Where JAX's persistent compilation cache lives.

A cold compile of the registration program takes minutes, so every entry
point keeps compiled programs on disk.  One rule for all of them:

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads the variable itself, and
  nothing here sets a directory.
* otherwise: ``<checkout>/.jax_cache``, a fixed path (the path is part of
  the cache key, so a directory that moves never hits).
"""

from __future__ import annotations

import os

__all__ = ["enable_compile_cache", "default_cache_dir"]

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def default_cache_dir() -> str:
    """``<checkout>/.jax_cache`` (listed in ``.gitignore``)."""
    return os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (see the
    module docstring) and return that directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = default_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path

"""Persistent XLA compilation cache location, shared by every entry point.

``JAX_COMPILATION_CACHE_DIR``, when set, is read by JAX itself and nothing
else is configured here. Otherwise the cache lives at the fixed
``<checkout>/.jax_cache`` (git-ignored): a fixed path, because the path is
part of the cache key, so runs from the same checkout find each other's
compiled programs.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["CHECKOUT_CACHE", "compile_cache_dir", "enable_compile_cache"]

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"
_ENV = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir() -> str:
    """The directory the cache uses: the environment's, else the checkout's."""
    return os.environ.get(_ENV) or str(CHECKOUT_CACHE)


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at :func:`compile_cache_dir`; returns it."""
    path = compile_cache_dir()
    if not os.environ.get(_ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path

"""Persistent XLA compilation cache (repeat runs skip their compiles).

Call :func:`enable_cache` before the first jit compilation.  The cache is
keyed on the full HLO, so code edits invalidate naturally.
"""
from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", ".jax_cache"
)


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else ``.jax_cache/`` in the
    checkout (a fixed path: the path is part of the cache key)."""
    return os.path.abspath(os.environ.get(ENV_VAR) or DEFAULT_DIR)


def enable_cache(min_compile_secs: float = 2.0) -> str:
    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return path

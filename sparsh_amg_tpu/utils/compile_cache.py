"""Persistent XLA compile cache location.

Every entry point (CLI, benchmark, smoke test, scripts, multi-process
workers, tests) calls :func:`enable_compile_cache` once before its first
compile.  ``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads the
variable itself and nothing here overrides it.  Otherwise the cache lives
at a fixed ``<checkout>/.jax_cache`` (listed in ``.gitignore``); the path
is part of the cache key, so it must not move between runs.
"""
from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program: the solve's many small programs each compile
    # in well under JAX's default one-second threshold
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path

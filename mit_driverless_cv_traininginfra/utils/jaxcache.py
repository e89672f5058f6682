"""Persistent XLA compilation cache — the one-liner every entry script needs.

A cold compile of the fused pipeline or a train step takes tens of seconds,
so every benchmark, tool and driver entry point enables the on-disk cache
before its first compile. Cache keys include the compiler version, so a
toolchain update recompiles naturally.

The directory is ``JAX_COMPILATION_CACHE_DIR`` when that is set, and
otherwise one fixed directory inside the checkout (``.jax_cache``, listed
in ``.gitignore``): the path is part of the cache's key, so it must not
move between runs.

Call :func:`enable_compile_cache` BEFORE the first jit/compile (importing
jax first is fine).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    """Where the compile cache lives: the environment variable wins."""
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point jax at the persistent compilation cache and cache every entry
    regardless of size or compile time. Returns the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path

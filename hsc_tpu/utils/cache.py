"""Persistent XLA compilation cache helper.

The persistent cache lets every later process reuse compiled executables.
It lives where `JAX_COMPILATION_CACHE_DIR` says when that is set (and then
nothing else is configured here), otherwise in `.jax_cache/` at the root of
the checkout — a fixed path, since the path is part of the cache key.
Call early (before the first jit execution).
"""

import os

import jax

DEFAULT_CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache")


def enable_compilation_cache(path: str | None = None) -> None:
    if path is None and os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return  # JAX reads the variable itself
    path = os.path.abspath(path or DEFAULT_CACHE_DIR)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

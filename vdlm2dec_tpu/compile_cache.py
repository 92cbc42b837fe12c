"""Persistent XLA compilation cache shared by every entry point.

Each new process (CLI run, bench, scan, worker) would otherwise compile
every program shape again.  With JAX's persistent compilation cache a
later process with the same program shape loads the executable instead.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
module sets no other directory.  Otherwise the cache lives at the fixed
path <checkout>/.jax_cache: the path is part of the cache key, so a
directory that moved between runs would never hit.
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory.

    Call once per process, before the first jit compilation (later calls
    are fine too — JAX picks the config up per compile)."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every program that took >= 1 s to compile, however small
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path

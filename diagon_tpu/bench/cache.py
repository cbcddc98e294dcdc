"""Where the benchmarks keep what they build.

Expensive deterministic artifacts (scale segments, columnar tables,
oracle results) live in ``<repo>/.bench_cache``, which ``.gitignore``
lists: nothing in it is source, and everything is rebuilt by
``scripts/build_scale.py`` and the benchmarks themselves.
``DIAGON_CACHE_DIR`` moves it.

``enable_compile_cache()`` is the one place an entry point sets up JAX's
persistent compilation cache.
"""

from __future__ import annotations

import os


def _repo_root() -> str:
    return os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )


def bench_cache_dir() -> str:
    """The benchmark cache directory (created on first use)."""
    d = os.environ.get("DIAGON_CACHE_DIR") or os.path.join(
        _repo_root(), ".bench_cache"
    )
    os.makedirs(d, exist_ok=True)
    return d


def find_cached(name: str) -> str | None:
    """Path of ``name`` (file or directory) in the cache, or None."""
    p = os.path.join(bench_cache_dir(), name)
    return p if os.path.exists(p) else None


def cache_path(name: str) -> str:
    """Path for writing ``name`` into the cache."""
    return os.path.join(bench_cache_dir(), name)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its path.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here. Otherwise the cache is the fixed in-checkout
    path ``<repo>/.bench_cache/jax_cache``: the path is part of what a
    cached entry is found by, so it must not move between runs."""
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if d:
        return d
    import jax

    d = os.path.join(_repo_root(), ".bench_cache", "jax_cache")
    jax.config.update("jax_compilation_cache_dir", d)
    return d

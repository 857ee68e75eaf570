"""Persistent XLA compilation cache management.

The blocked solvers, the temporal-parallel Kalman smoother
(ops/pkalman.py, ~17 ``associative_scan`` levels) and the samplers'
jitted segments take seconds to minutes to compile; JAX's persistent
compilation cache turns that into a once-per-checkout cost.

The library never mutates global JAX config on import; call
:func:`enable_persistent_cache` explicitly (``chip_smoke.py``,
``bench.py``, the examples and benchmarks do).
"""

from __future__ import annotations

import os

__all__ = ["enable_persistent_cache", "DEFAULT_CACHE_DIR"]

# One fixed directory inside the checkout (listed in .gitignore): the
# path is part of the cache key, so it must not move between runs.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__
    )))),
    ".cache", "xla",
)


def enable_persistent_cache(min_compile_secs=1.0):
    """Turn on JAX's persistent compilation cache and return its path.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already uses that
    directory and nothing else is configured here.  Otherwise the cache
    goes to :data:`DEFAULT_CACHE_DIR`, and programs whose compile took
    less than ``min_compile_secs`` are not persisted.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return DEFAULT_CACHE_DIR

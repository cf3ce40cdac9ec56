"""JAX persistent compilation cache, kept at one fixed place.

The cache key includes the directory, so a directory that moves never hits.
If `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and nothing here
overrides it; otherwise the cache lives in `.jax_cache/` at the checkout root
(listed in .gitignore). The CPU test suite keeps the cache off
(tests/conftest.py).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: checkout root: rs_tfhe_tpu/utils/cache.py -> ../../..
CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> tuple[str, bool]:
    """(directory, whether it comes from the environment)."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env, True
    return os.path.join(CHECKOUT_ROOT, ".jax_cache"), False


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    import jax

    path, from_env = compile_cache_dir()
    if not from_env:
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.3)
    return path

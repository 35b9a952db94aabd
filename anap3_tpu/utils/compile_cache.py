"""Persistent XLA compile cache, enabled on every entry path.

The cache lives where ``JAX_COMPILATION_CACHE_DIR`` says when that variable
is set, and otherwise at the fixed ``<repo>/.jax_cache`` (a cache's path is
part of its key, so a directory that moves never hits). bench.py,
chip_smoke.py and the solver constructors all call enable_compile_cache()
(idempotent) so a rerun reuses every program compiled before.
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"

_enabled = False


def cache_dir() -> Path:
    """The directory the persistent compile cache uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    return Path(env) if env else DEFAULT_CACHE_DIR


def enable_compile_cache() -> Path:
    """Point JAX's persistent compile cache at cache_dir(); returns it."""
    global _enabled
    path = cache_dir()
    if _enabled:
        return path
    import jax

    path.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    _enabled = True
    return path

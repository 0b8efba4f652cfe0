"""Persistent XLA compilation cache placement, shared by every entry point.

`JAX_COMPILATION_CACHE_DIR`, when set, is the only directory used (JAX
reads it itself; this helper sets no other).  Otherwise the cache lives at
a FIXED path inside the checkout, `<repo>/.jax_cache` (listed in
.gitignore): the cache key includes the directory, so a path that moved
between runs would never hit.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its one directory and
    cache every compile (the step programs are few and expensive).
    Returns the directory in use."""
    import jax

    path = os.environ.get(ENV_VAR) or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path

"""Where the persistent XLA compilation cache lives.

Every entry point (CLI, bench.py, chip_smoke.py, scripts, the test
harness) calls enable() before its first compile, so all of them share one
cache.  JAX keys cached programs partly by the cache path, so the path is
fixed: the JAX_COMPILATION_CACHE_DIR environment variable when it is set
(JAX reads it itself, and nothing is set here), else <repo>/.jax_cache.
"""

from __future__ import annotations

import os

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR

"""Persistent XLA compilation cache for the program's entry points."""

from __future__ import annotations

import os

import jax

# <checkout>/.jax_cache: a fixed path, because the path is part of the
# cache key — a directory that moves never hits.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
    is set here; otherwise the cache goes to DEFAULT_DIR.  Called by
    driver.main, bench.py and chip_smoke.py before their first compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

"""Persistent XLA compilation cache location.

Entry points (the CLI, bench.py, chip_smoke.py, scripts/) call
``enable()`` before their first compilation.  When the environment sets
``JAX_COMPILATION_CACHE_DIR``, JAX already uses it and nothing is set
here; otherwise the cache lives at ``<repo root>/.jax_cache``, a fixed
path so that later runs from the same checkout find it.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

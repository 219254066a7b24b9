"""JAX's persistent compilation cache at one fixed place.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
is set here.  Otherwise the cache goes to ``<repo>/.jax_cache``, a
fixed path: a directory that moved between runs would never be found
again.
"""

from __future__ import annotations

import os

import jax

REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)
    ))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR

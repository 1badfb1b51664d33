"""Persistent compilation cache placement, shared by every entry point.

Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing
here overrides it. Otherwise the cache lives at one fixed directory of
the checkout (listed in .gitignore): the cache key includes the path, so
a directory that moved between runs would never hit.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    path = os.environ.get(ENV)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

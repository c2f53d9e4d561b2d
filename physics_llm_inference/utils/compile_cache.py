"""Persistent compilation cache location.

A cold 7B run compiles several 32-layer programs; the cache keeps them
across processes. Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it
itself and nothing here overrides it. Otherwise the cache lives at one fixed
directory inside the checkout (listed in .gitignore): the directory is part
of what a later run looks up, so it must not move between runs.
"""
from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """The directory the cache uses: $JAX_COMPILATION_CACHE_DIR if set,
    else the fixed in-checkout directory."""
    return os.environ.get(ENV_VAR) or str(CHECKOUT_DIR)


def enable_compile_cache() -> str:
    """Point JAX at the cache directory (entry points call this once,
    before compiling). Returns the directory."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path

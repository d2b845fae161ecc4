"""The one persistent XLA compile cache shared by every entry point.

A full-codec compile takes minutes, and JAX keys its persistent cache by
directory, so every process of this repository uses the same one.
"""
from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".cache" / "jax"


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and nothing
    is changed here. Otherwise the cache goes to <repo>/.cache/jax, which
    .gitignore lists. Returns the directory in use. Call before the first
    compile."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return str(REPO_CACHE_DIR)

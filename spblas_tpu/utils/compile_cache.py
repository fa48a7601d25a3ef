"""Persistent compilation cache placement for the entry scripts.

JAX keeps its compile cache where ``JAX_COMPILATION_CACHE_DIR`` says when
that variable is set, and then nothing here touches it.  Otherwise the
scripts use one fixed directory inside the checkout (``.jax_cache/``,
git-ignored): the path is part of the cache key, so it must not move
between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def compile_cache_dir(root: str) -> str | None:
    """The directory to configure in code, or None when the environment
    variable already names one."""
    if os.environ.get(ENV_VAR):
        return None
    return os.path.join(os.path.abspath(root), ".jax_cache")


def enable_compile_cache(root: str) -> str:
    """Point JAX's persistent cache at the fixed directory under ``root``
    unless the environment names one; returns the directory in use."""
    path = compile_cache_dir(root)
    if path is None:
        return os.environ[ENV_VAR]
    import jax
    jax.config.update("jax_compilation_cache_dir", path)
    return path

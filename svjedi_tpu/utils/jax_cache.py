"""Placement of JAX's persistent compilation cache."""

from __future__ import annotations

import os
from pathlib import Path

#: Cache directory inside the checkout (git-ignored), used when
#: JAX_COMPILATION_CACHE_DIR is unset. It is fixed because the path is part
#: of what the cache matches on: a directory that moves never hits.
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory.

    A set ``JAX_COMPILATION_CACHE_DIR`` is JAX's own setting and is left
    alone; otherwise the cache goes to :data:`DEFAULT_DIR`. Returns the
    directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_DIR))
    return str(DEFAULT_DIR)

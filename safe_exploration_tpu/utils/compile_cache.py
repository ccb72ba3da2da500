"""Where JAX's persistent compilation cache lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this module
sets no directory of its own. Otherwise the cache goes to one fixed directory
inside the checkout, ``<repo>/.jax_cache`` (listed in ``.gitignore``): the path
is part of what makes a cache entry findable again, so it never depends on a
temporary directory, a process id or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["ENV_VAR", "compile_cache_dir", "enable_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get(ENV_VAR) or str(REPO_CACHE_DIR)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    Entries are kept for every program that takes more than half a second
    to compile, whatever their size."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return compile_cache_dir()

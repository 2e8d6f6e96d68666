"""JAX runtime configuration helpers.

The fused block pipeline takes long to compile at the level-9 shapes; the
persistent compilation cache lets every process after the first reuse
those executables.  Applied on pipeline import (idempotent).
"""

from __future__ import annotations

import os

# The checkout's own cache: a fixed path (the path is part of what makes a
# later process find the entries again), listed in .gitignore.
_CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".jax_cache",
)
_done = False


def cache_dir() -> str:
    """``JAX_COMPILATION_CACHE_DIR`` exactly when set, else the checkout's
    ``.jax_cache/``."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _CHECKOUT_CACHE


def enable_compile_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2)

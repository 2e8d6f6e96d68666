"""Small shared utilities."""

import os

from .jaxcfg import cache_dir, enable_compile_cache
from .pool import spawn_pool

__all__ = ["cache_dir", "enable_compile_cache", "env_setting", "spawn_pool"]


def env_setting(name: str, default: str = "") -> str:
    """``os.environ[name]``, or ``default`` when unset.

    The same setting under another spelling (a ``BANZAI_..._<suffix>``
    variable with an extra word, as older releases named it) raises
    instead of being silently ignored.
    """
    suffix = name[len("BANZAI"):]
    stray = sorted(
        k for k in os.environ
        if k != name and k.startswith("BANZAI_") and k.endswith(suffix)
    )
    if stray:
        raise RuntimeError(f"{', '.join(stray)} is not read: set {name}")
    return os.environ.get(name, default)

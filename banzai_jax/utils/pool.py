"""Spawn-context process pools that stay off the accelerator.

Worker processes of both the host block-parallel pool (encoder_host) and
the hybrid host+device scheduler (pipeline) are NumPy-only.  A worker that
initialized an accelerator backend would reserve device memory the parent
already holds, so each worker is spawned with ``JAX_PLATFORMS=cpu``.
Children inherit ``os.environ`` at exec time, so the only lever is the
parent's environment during the spawn.  The mutation window is scoped as
tightly as multiprocessing allows (set → spawn → restore in a
``finally``) and serialized behind a module lock so concurrent pool
creations never interleave their save/restore.

Fork is never used: the parent typically holds XLA runtime threads, and
forking a multithreaded process deadlocks (reference-free hazard — see
CPython docs on fork+threads).  Spawned workers re-import by module
path, which is why the worker functions live in jax-free modules.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import threading

_ENV_LOCK = threading.Lock()


def spawn_pool(jobs: int) -> "mp.pool.Pool":
    """A spawn-context Pool whose workers see a CPU-only environment."""
    with _ENV_LOCK:
        prev_plat = os.environ.get("JAX_PLATFORMS")
        os.environ["JAX_PLATFORMS"] = "cpu"
        try:
            return mp.get_context("spawn").Pool(jobs)
        finally:
            if prev_plat is None:
                os.environ.pop("JAX_PLATFORMS", None)
            else:
                os.environ["JAX_PLATFORMS"] = prev_plat

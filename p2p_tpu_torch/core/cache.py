"""The kernel build cache (counterpart of ``p2p_tpu/core/cache.py``): the
JAX package points XLA's persistent compilation cache at a directory, so a
restarted process reloads its programs instead of compiling them. What the
port compiles is its CUDA kernel libraries (``ops/cuda/build.py``) and its
host image library (``native/``), so the same knob
(``TrainConfig.compilation_cache_dir``, ``--compilation_cache`` of
``cli.train``, ``cli.serve`` and ``cli.infer``) names the directory they
are built into and reused from: a preempted or restarted process on the same
machine, or a fleet sharing the directory, builds each library once. The
build watchdog (obs/watchdogs.py) counts the builds and the reuses.
"""

from __future__ import annotations

import os
from typing import Optional

_enabled_dir: Optional[str] = None


def enable_compilation_cache(cache_dir: str) -> str:
    """Build the kernel libraries into (and reuse them from) ``cache_dir``,
    created if missing. Idempotent; returns the absolute directory. Call
    before the first kernel launch: a library already loaded stays
    loaded."""
    global _enabled_dir
    cache_dir = os.path.abspath(cache_dir)
    os.makedirs(cache_dir, exist_ok=True)
    _enabled_dir = cache_dir
    return cache_dir


def compilation_cache_dir() -> Optional[str]:
    """The directory :func:`enable_compilation_cache` set (None when the
    process never enabled one: the libraries go to ``build/torch_ext/``)."""
    return _enabled_dir

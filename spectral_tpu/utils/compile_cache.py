"""Where compiled programs persist between processes.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` by itself, so when it is set this
module sets nothing. Otherwise the cache lives at one fixed path inside the
checkout, ``<checkout>/.jax_cache`` (git-ignored): the path is part of the
cache's key, so a directory named after a temporary name, a process id or
a time would never be hit again. ``main``, ``bench.py`` and
``chip_smoke.py`` all call ``configure_compile_cache`` before compiling.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = CHECKOUT / ".jax_cache"
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def configure_compile_cache(environ=None) -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    environ = os.environ if environ is None else environ
    if environ.get(ENV_VAR):
        return environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)

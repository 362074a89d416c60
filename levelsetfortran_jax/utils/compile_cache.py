"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (the CLI, ``chip_smoke.py``, ``bench.py``
and the tests): when ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
and nothing is set in code; otherwise the cache lives at the fixed
``<repo>/.jax_cache``.  The path never depends on a temp name, a process
id or the time, so every later run finds what an earlier one stored.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

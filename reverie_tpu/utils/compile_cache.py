"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (CLI, benchmarks, the chip smoke run, the
tests): a `JAX_COMPILATION_CACHE_DIR` set in the environment wins and JAX
reads it itself, so nothing is set here; otherwise the cache lives at one
fixed path inside the checkout, `<repo>/.jax_cache` (listed in .gitignore).
A fixed path matters because the directory is part of the cache key: a
directory that moves between runs never hits.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

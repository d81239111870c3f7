"""One rule for JAX's persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and nothing
else is configured here. Otherwise the cache lives in ``.jax_cache`` at the
root of the checkout (listed in ``.gitignore``), optionally in a
subdirectory of it, so a program never writes outside its checkout.
"""
from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable(subdir: str = "") -> str:
    """Point JAX's persistent cache at its directory and return that path."""
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    cache_dir = os.path.join(REPO_ROOT, ".jax_cache", subdir)
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir

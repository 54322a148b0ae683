"""Where JAX keeps its persistent compile cache.

A set ``JAX_COMPILATION_CACHE_DIR`` wins: JAX reads it itself and nothing
here overrides it.  Otherwise the cache lives at ``<repo>/.jax_cache``
(listed in ``.gitignore``), a fixed path, so later processes of the same
checkout find what earlier ones compiled.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at its directory; returns it."""
    if os.environ.get(ENV):
        return os.environ[ENV]
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR

"""Persistent XLA compilation cache: one place decides where it lives.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets nothing. Otherwise the cache is ``<checkout>/.jax_cache`` (listed in
``.gitignore``), a fixed path, so later processes of the same checkout find
what earlier ones compiled.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT = Path(__file__).resolve().parents[2]


def cache_dir() -> Optional[str]:
    """The directory this program configures, or None when the environment
    variable is set (JAX then uses it without help)."""
    if os.environ.get(ENV_VAR):
        return None
    return str(CHECKOUT / ".jax_cache")


def enable_compilation_cache() -> str:
    """Point JAX at the cache (see module doc); returns the directory in use.
    CPU runs skip it: their compiles are fast, and the CLI also runs
    in-process under pytest, where a config update would leak into every
    later test."""
    import jax

    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    if jax.default_backend() == "cpu":
        return "(none: CPU backend)"
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path

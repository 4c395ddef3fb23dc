"""PRNG implementation selection: one default on every platform.

``auto`` is the partitionable ``threefry2x32`` (bit-reproducible across
platforms and shardings; tests pin golden values on it). ``rbg`` stays
selectable; PERF.md records the on-card comparison that kept threefry as
the default.
"""

from __future__ import annotations

import jax


def make_key(seed: int, impl: str = "auto") -> jax.Array:
    """``impl``: auto | threefry | rbg."""
    if impl in ("auto", "threefry"):
        impl = "threefry2x32"
    return jax.random.key(seed, impl=impl)

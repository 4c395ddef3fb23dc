"""Walker resampling (branching) kernels for DMC.

Reference: ``random.choice(p=weights)`` multinomial resampling at
vmc_dmc...:255-260 — an O(N) gather behind an O(N log N) sort inside
``choice``. Both resamplers here are inverse-CDF based (cumsum +
``searchsorted`` + gather), which XLA lowers to scans and one gather:

- ``multinomial``: N iid uniforms (distribution-identical to the reference).
- ``systematic``: one uniform offset, stratified comb — lower variance and
  cheaper (the standard particle-filter resampler; SURVEY.md §7 "hard parts").

Both keep the population size fixed, as the reference does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import random


def _sanitize(weights: jax.Array) -> jax.Array:
    """Reference-equivalent weight hygiene (vmc_dmc...:250-253): NaN/Inf ->
    tiny, renormalize; degenerate sum -> uniform."""
    n = weights.shape[0]
    w = jnp.nan_to_num(weights, nan=1e-9, posinf=1e-9, neginf=1e-9)
    w = jnp.maximum(w, 0.0)
    s = jnp.sum(w)
    return jnp.where(s > 0, w / s, jnp.full_like(w, 1.0 / n))


def resample_multinomial(key: jax.Array, walkers: jax.Array, weights: jax.Array) -> jax.Array:
    """Draw N indices iid from Categorical(weights); gather walkers."""
    n = walkers.shape[0]
    w = _sanitize(weights)
    cdf = jnp.cumsum(w)
    u = random.uniform(key, (n,), dtype=w.dtype)
    idx = jnp.searchsorted(cdf, u, side="right")
    idx = jnp.clip(idx, 0, n - 1)
    return jnp.take(walkers, idx, axis=0)


def resample_systematic(key: jax.Array, walkers: jax.Array, weights: jax.Array) -> jax.Array:
    """Stratified comb: positions (i + u)/N against the weight CDF."""
    n = walkers.shape[0]
    w = _sanitize(weights)
    cdf = jnp.cumsum(w)
    u0 = random.uniform(key, (), dtype=w.dtype)
    pts = (jnp.arange(n, dtype=w.dtype) + u0) / n
    idx = jnp.searchsorted(cdf, pts, side="right")
    idx = jnp.clip(idx, 0, n - 1)
    return jnp.take(walkers, idx, axis=0)


RESAMPLERS = {
    "multinomial": resample_multinomial,
    "systematic": resample_systematic,
}

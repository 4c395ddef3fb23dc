"""Shared test helpers."""

import jax
import jax.numpy as jnp
import numpy as np


def lattice_positions(n, box, dim=2, jitter=0.05, seed=0):
    """Square/cubic lattice filling ``box`` with a seeded Gaussian jitter
    (``jitter`` sigma) — an overlap-free start with real net forces."""
    per_side = int(np.ceil(n ** (1.0 / dim)))
    spacing = box / per_side
    grid = jnp.arange(per_side, dtype=jnp.float32) * spacing + 0.5 * spacing
    mesh = jnp.stack(jnp.meshgrid(*([grid] * dim), indexing="ij"), axis=-1)
    r = mesh.reshape(-1, dim)[:n]
    return r + jitter * jax.random.normal(jax.random.PRNGKey(seed), r.shape)

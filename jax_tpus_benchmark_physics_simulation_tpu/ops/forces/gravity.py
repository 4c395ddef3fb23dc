"""Newtonian pairwise gravity (vectorized, O(N^2) dense path).

Reference physics appears twice with different regularizations:
- nbody...:54-67: unrolled double Python loop, ``where(r >= 1e-6, G m_j / r^3, 0)``
  hard cutoff (``min_distance`` mode here).
- three_particles...:25-37: vectorized, ``r^2 + eye`` self-exclusion and a
  ``1e-12`` floor on r^2 (``r2_floor`` mode here).

Both are reproduced exactly (for parity tests) by a single vectorized
implementation — no unrolled Python loops; works for any N.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax_tpus_benchmark_physics_simulation_tpu.utils import struct


@struct.dataclass
class Gravity:
    g: float = struct.field(pytree_node=False, default=1.0)
    # Regularization mode:
    #   "min_distance": acc term zeroed when r < min_distance (nbody...:64)
    #   "r2_floor": r^2 += eye, then floored at r2_floor (three_particles...:28-30)
    #   "plummer": softening r^2 -> r^2 + eps^2 (standard, branch-free)
    mode: str = struct.field(pytree_node=False, default="plummer")
    min_distance: float = struct.field(pytree_node=False, default=1e-6)
    r2_floor: float = struct.field(pytree_node=False, default=1e-12)
    softening: float = struct.field(pytree_node=False, default=0.0)

    def acceleration(self, position: jax.Array, mass: jax.Array) -> jax.Array:
        """a_i = sum_{j != i} G m_j (R_j - R_i) / r^3 (regularized)."""
        n = position.shape[0]
        dr = position[None, :, :] - position[:, None, :]  # dr[i, j] = R_j - R_i
        r2 = jnp.sum(dr * dr, axis=-1)
        eye = jnp.eye(n, dtype=position.dtype)

        if self.mode == "min_distance":
            r2_safe = jnp.where(r2 < self.min_distance**2, 1.0, r2)
            inv_r3 = r2_safe ** (-1.5)
            inv_r3 = jnp.where(r2 >= self.min_distance**2, inv_r3, 0.0)
        elif self.mode == "r2_floor":
            r2 = r2 + eye
            r2 = jnp.where(r2 < self.r2_floor, self.r2_floor, r2)
            inv_r3 = r2 ** (-1.5)
            inv_r3 = inv_r3 * (1.0 - eye)
        elif self.mode == "plummer":
            r2 = r2 + self.softening**2 + eye  # eye keeps diagonal finite
            inv_r3 = r2 ** (-1.5) * (1.0 - eye)
        else:
            raise ValueError(f"unknown gravity mode: {self.mode}")

        acc_pairs = self.g * mass[None, :, None] * dr * inv_r3[..., None]
        return jnp.sum(acc_pairs, axis=1)

    def force(self, position: jax.Array, mass: jax.Array) -> jax.Array:
        return self.acceleration(position, mass) * mass[:, None]

    def energy(self, position: jax.Array, mass: jax.Array) -> jax.Array:
        """Total potential energy -G sum_{i<j} m_i m_j / r (plummer-softened)."""
        n = position.shape[0]
        dr = position[None, :, :] - position[:, None, :]
        r2 = jnp.sum(dr * dr, axis=-1)
        eye = jnp.eye(n, dtype=position.dtype)
        r = jnp.sqrt(r2 + self.softening**2 + eye)
        pot = -self.g * mass[:, None] * mass[None, :] / r * (1.0 - eye)
        return 0.5 * jnp.sum(pot)

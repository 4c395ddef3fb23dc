"""Electromagnetic (Lorentz) acceleration in 2D with non-uniform B_z(x).

Reference physics: three_particles...:39-51 —
  B_z(x) = Bz + Bk * x  (gradient along x),
  a_mag = (q/m) (v x B) = (q/m) (v_y B_z, -v_x B_z)   [2D],
  a_elec = (q/m) (E_x, E_y).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax_tpus_benchmark_physics_simulation_tpu.utils import struct


@struct.dataclass
class Lorentz2D:
    bz: float = struct.field(pytree_node=False, default=1.0)
    bk: float = struct.field(pytree_node=False, default=0.0)
    ex: float = struct.field(pytree_node=False, default=0.0)
    ey: float = struct.field(pytree_node=False, default=0.0)

    def b_field(self, position: jax.Array) -> jax.Array:
        """Out-of-plane B_z at each particle, shape (N,)."""
        return self.bz + self.bk * position[:, 0]

    def e_field(self, position: jax.Array) -> jax.Array:
        """In-plane E at each particle, shape (N, 2)."""
        e = jnp.array([self.ex, self.ey], dtype=position.dtype)
        return jnp.broadcast_to(e, position.shape)

    def acceleration(
        self,
        position: jax.Array,
        velocity: jax.Array,
        mass: jax.Array,
        charge: jax.Array,
    ) -> jax.Array:
        qm = charge / mass
        bz = self.b_field(position)
        acc_mag = jnp.stack(
            [qm * velocity[:, 1] * bz, -qm * velocity[:, 0] * bz], axis=1
        )
        acc_elec = qm[:, None] * self.e_field(position)
        return acc_mag + acc_elec

"""Lennard-Jones 6-12 potential with optional PBC and cutoff.

Reference physics: ``total_energy_fn`` at molecular_dynamics...:50-62
(full O(N^2) pair matrix, no cutoff, forces via ``grad`` at :64).
Here: analytic dense energy/force (oracle + XLA-fused path) and a cutoff
option (with energy shift) the reference lacks. ``force_on`` checks large
systems against the same oracle without building an (N, N) array.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from jax_tpus_benchmark_physics_simulation_tpu.ops.forces.pbc import (
    minimum_image,
    pair_displacements,
)
from jax_tpus_benchmark_physics_simulation_tpu.utils import struct


@struct.dataclass
class LennardJones:
    sigma: float = struct.field(pytree_node=False, default=1.0)
    epsilon: float = struct.field(pytree_node=False, default=1.0)
    box: Optional[float] = struct.field(pytree_node=False, default=None)
    cutoff: Optional[float] = struct.field(pytree_node=False, default=None)

    def _pair_terms(self, position: jax.Array):
        n = position.shape[0]
        dr = pair_displacements(position, self.box)
        r2 = jnp.sum(dr * dr, axis=-1)
        mask = ~jnp.eye(n, dtype=bool)
        if self.cutoff is not None:
            mask = mask & (r2 < self.cutoff**2)
        r2_safe = jnp.where(mask, r2, 1.0)
        s2 = (self.sigma**2) / r2_safe
        s6 = s2 * s2 * s2
        s12 = s6 * s6
        return dr, r2_safe, mask, s6, s12

    def _shift(self) -> float:
        """Energy shift so U(r_c) = 0 when a cutoff is used."""
        if self.cutoff is None:
            return 0.0
        sc2 = (self.sigma / self.cutoff) ** 2
        sc6 = sc2**3
        return 4.0 * self.epsilon * (sc6 * sc6 - sc6)

    def energy(self, position: jax.Array) -> jax.Array:
        """Total potential energy (scalar), dense O(N^2)."""
        _, _, mask, s6, s12 = self._pair_terms(position)
        pair = 4.0 * self.epsilon * (s12 - s6) - self._shift()
        return 0.5 * jnp.sum(jnp.where(mask, pair, 0.0))

    def force(self, position: jax.Array) -> jax.Array:
        """Analytic forces ``-dE/dR``, dense O(N^2).

        F_i = sum_j 24 eps (2 s12 - s6) / r^2 * (R_i - R_j); verified against
        ``jax.grad(energy)`` in tests/test_forces.py.
        """
        dr, r2_safe, mask, s6, s12 = self._pair_terms(position)
        fmag_over_r = 24.0 * self.epsilon * (2.0 * s12 - s6) / r2_safe
        fmag_over_r = jnp.where(mask, fmag_over_r, 0.0)
        return jnp.sum(fmag_over_r[..., None] * dr, axis=1)

    def energy_per_particle(self, position: jax.Array) -> jax.Array:
        """Per-particle energy e_i (sum e_i / 2 = total)."""
        _, _, mask, s6, s12 = self._pair_terms(position)
        pair = 4.0 * self.epsilon * (s12 - s6) - self._shift()
        return jnp.sum(jnp.where(mask, pair, 0.0), axis=1)

    def force_and_energy(self, position: jax.Array):
        dr, r2_safe, mask, s6, s12 = self._pair_terms(position)
        fmag_over_r = jnp.where(mask, 24.0 * self.epsilon * (2.0 * s12 - s6) / r2_safe, 0.0)
        f = jnp.sum(fmag_over_r[..., None] * dr, axis=1)
        pair = 4.0 * self.epsilon * (s12 - s6) - self._shift()
        e = 0.5 * jnp.sum(jnp.where(mask, pair, 0.0))
        return f, e

    def force_on(self, position: jax.Array, idx: jax.Array, block: int = 8192) -> jax.Array:
        """Forces on the particles ``idx`` from all N, the same physics as
        :meth:`force`, summed over partner blocks of ``block`` particles so
        that no (N, N) array exists: memory is O(len(idx) * block)."""
        n, dim = position.shape
        n_blocks = -(-n // block)
        padded = jnp.zeros((n_blocks * block, dim), position.dtype).at[:n].set(position)
        targets = position[idx]

        def body(k, acc):
            start = k * block
            part = jax.lax.dynamic_slice_in_dim(padded, start, block)
            j = start + jnp.arange(block)
            dr = targets[:, None, :] - part[None, :, :]
            if self.box is not None:
                dr = minimum_image(dr, self.box)
            r2 = jnp.sum(dr * dr, axis=-1)
            mask = (j[None, :] != idx[:, None]) & (j < n)[None, :]
            if self.cutoff is not None:
                mask = mask & (r2 < self.cutoff**2)
            r2_safe = jnp.where(mask, r2, 1.0)
            s2 = (self.sigma**2) / r2_safe
            s6 = s2 * s2 * s2
            fmag = jnp.where(mask, 24.0 * self.epsilon * (2.0 * s6 * s6 - s6) / r2_safe, 0.0)
            return acc + jnp.sum(fmag[..., None] * dr, axis=1)

        return jax.lax.fori_loop(
            0, n_blocks, body, jnp.zeros(targets.shape, position.dtype)
        )

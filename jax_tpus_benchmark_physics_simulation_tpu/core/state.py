"""State containers (pytrees) for the simulation engine.

The reference keeps state as loose tuples / flat vectors per script
(e.g. ``(R, V)`` in molecular_dynamics_jax_single-host_workload.py:136,
flat ``y = [pos, vel]`` in nbody_bh_merger_sim_single-host_workload.py:72-76,
``(walkers, alpha, key, opt_state)`` in vmc_dmc_jax_quantum_harmonic_oscillator.py:131).
Here there is one typed, jit-friendly pytree per domain so every integrator,
observable, and sharding rule composes against the same container.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax_tpus_benchmark_physics_simulation_tpu.utils import struct


@struct.dataclass
class ParticleState:
    """Classical particle system state.

    Attributes:
      position: ``(N, D)`` positions.
      velocity: ``(N, D)`` velocities.
      mass: ``(N,)`` masses.
      charge: ``(N,)`` charges (zeros when not electromagnetic).
      force: ``(N, D)`` cached forces at ``position`` (carried across steps so
        velocity-Verlet costs one force evaluation per step instead of the
        reference's two, molecular_dynamics...:66-75).
      time: scalar simulation time.
    """

    position: jax.Array
    velocity: jax.Array
    mass: jax.Array
    charge: jax.Array
    force: jax.Array
    time: jax.Array

    @property
    def n(self) -> int:
        return self.position.shape[0]

    @property
    def dim(self) -> int:
        return self.position.shape[1]

    @classmethod
    def create(
        cls,
        position: jax.Array,
        velocity: jax.Array,
        mass: Optional[jax.Array] = None,
        charge: Optional[jax.Array] = None,
        time: float = 0.0,
    ) -> "ParticleState":
        position = jnp.asarray(position)
        velocity = jnp.asarray(velocity)
        n = position.shape[0]
        dtype = position.dtype
        if mass is None:
            mass = jnp.ones((n,), dtype=dtype)
        else:
            mass = jnp.asarray(mass, dtype=dtype)
        if charge is None:
            charge = jnp.zeros((n,), dtype=dtype)
        else:
            charge = jnp.asarray(charge, dtype=dtype)
        force = jnp.zeros_like(position)
        return cls(
            position=position,
            velocity=velocity,
            mass=mass,
            charge=charge,
            force=force,
            time=jnp.asarray(time, dtype=dtype),
        )

    def flatten(self) -> jax.Array:
        """Flat ODE vector ``[pos..., vel...]`` (reference layout, nbody...:72-76)."""
        return jnp.concatenate([self.position.ravel(), self.velocity.ravel()])

    def with_flat(self, y: jax.Array) -> "ParticleState":
        n, d = self.position.shape
        return self.replace(
            position=y[: n * d].reshape(n, d),
            velocity=y[n * d :].reshape(n, d),
        )


@struct.dataclass
class WalkerState:
    """Monte Carlo walker ensemble state (VMC/DMC).

    Reference analog: ``(walkers, alpha, key, opt_state)`` tuple at
    vmc_dmc_jax_quantum_harmonic_oscillator.py:131 and ``(walkers, key)``
    at :276. Here walkers and the PRNG key live in one container; variational
    parameters / optimizer state ride alongside in the VMC driver.
    """

    walkers: jax.Array  # (n_walkers, dim)
    key: jax.Array  # PRNG key

    @property
    def n_walkers(self) -> int:
        return self.walkers.shape[0]

    @property
    def dim(self) -> int:
        return self.walkers.shape[1]

    @classmethod
    def create(cls, key: jax.Array, n_walkers: int, dim: int, dtype=jnp.float32) -> "WalkerState":
        key, sub = jax.random.split(key)
        walkers = jax.random.normal(sub, (n_walkers, dim), dtype=dtype)
        return cls(walkers=walkers, key=key)

"""Lyapunov exponent estimation, fully on device.

The reference (nbody...:175-208) re-runs the full trajectory from a perturbed
initial condition (two device programs) and post-processes the divergence on
the host. Two methods here:

- ``lyapunov_tangent``: Benettin tangent-space method — propagate a unit
  perturbation through ``jax.jvp`` of the step function inside the same scan,
  renormalizing each step and accumulating log stretch factors. One device
  program, numerically robust (no saturation of the perturbation); SURVEY.md
  §2b calls this out.
- ``lyapunov_two_trajectory``: the reference's estimator (lambda = mean over t
  of log(delta(t)/d0)/t) as a device-side computation for parity checks.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp
from jax import lax


def lyapunov_tangent(
    step_fn: Callable[[Any], Any],
    state0: Any,
    num_steps: int,
    dt: float,
    d0: float = 1e-6,
    key: jax.Array | None = None,
) -> jax.Array:
    """Largest Lyapunov exponent via the variational (tangent-space) method.

    ``step_fn`` must be a pure pytree -> pytree map (time-independent step).
    Returns lambda_max = (1 / (num_steps * dt)) * sum_k log(||J delta_k|| / d0).
    """
    flat0, unravel = jax.flatten_util.ravel_pytree(state0)
    dim = flat0.shape[0]

    def flat_step(y):
        return jax.flatten_util.ravel_pytree(step_fn(unravel(y)))[0]

    if key is None:
        delta0 = jnp.zeros_like(flat0).at[0].set(d0)  # matches nbody...:178
    else:
        v = jax.random.normal(key, (dim,), dtype=flat0.dtype)
        delta0 = d0 * v / jnp.linalg.norm(v)

    def body(carry, _):
        y, delta = carry
        y_new, jdelta = jax.jvp(flat_step, (y,), (delta,))
        norm = jnp.linalg.norm(jdelta)
        log_stretch = jnp.log(norm / d0)
        delta_new = jdelta * (d0 / jnp.maximum(norm, 1e-300))
        return (y_new, delta_new), log_stretch

    (_, _), log_stretches = lax.scan(body, (flat0, delta0), length=num_steps)
    return jnp.sum(log_stretches) / (num_steps * dt)


def lyapunov_two_trajectory(
    t: jax.Array,  # (T,)
    traj: jax.Array,  # (T, state_dim) flat trajectories
    traj_pert: jax.Array,  # (T, state_dim)
    d0: float = 1e-6,
) -> Tuple[jax.Array, jax.Array]:
    """Reference estimator (nbody...:197-206) on device.

    Returns ``(lyap, n_valid)``; lambda = mean over valid t of
    log(delta(t)/d0)/t with validity mask t > 1e-10 and delta > 1e-15.
    """
    delta = jnp.linalg.norm(traj - traj_pert, axis=1)
    valid = (t > 1e-10) & (delta > 1e-15)
    vals = jnp.where(valid, jnp.log(jnp.maximum(delta, 1e-300) / d0) / jnp.where(valid, t, 1.0), 0.0)
    n_valid = jnp.sum(valid)
    lyap = jnp.sum(vals) / jnp.maximum(n_valid, 1)
    return lyap, n_valid

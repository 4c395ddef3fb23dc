"""Mean-squared displacement and self-diffusion coefficient (on-device).

The reference samples trajectory snapshots (molecular_dynamics_jax_single-
host_workload.py:85-106) but computes no transport coefficient from them.
Here the production ``r_history`` — positions wrapped into [0, box) at a
fixed sampling stride — is unwrapped by minimum-image chaining: as long as
no particle moves more than box/2 between consecutive samples (true at any
sane ``sample_every``; a particle at the 8-sigma Maxwell tail covers
``8 sqrt(kT) * dt * sample_every`` << box/2), the per-interval displacement
is ``d - box*round(d/box)`` and displacements accumulate exactly.

MSD(k) averages over particles AND time origins (the standard sliding-
origin estimator); D comes from a least-squares slope over the second half
of the curve (the early ballistic regime is excluded), via the Einstein
relation ``MSD = 2 d D t``.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def unwrap_trajectory(r_history: jax.Array, box: float) -> jax.Array:
    """(S, N, d) wrapped snapshots -> unwrapped (continuous) trajectories.
    Valid while inter-sample motion stays under box/2 per axis."""
    d = jnp.diff(r_history, axis=0)
    d = d - box * jnp.round(d / box)
    return jnp.concatenate(
        [r_history[:1], r_history[:1] + jnp.cumsum(d, axis=0)], axis=0
    )


def mean_squared_displacement(
    r_history: jax.Array, box: float, max_particles: int = 4096
) -> jax.Array:
    """MSD over sample lag k = 0..S-1, averaged over particles and time
    origins: ``msd[k] = mean_{t,i} |r_i(t+k) - r_i(t)|^2``. O(S^2 N) — fine
    at sampling stride (S is 10s-100s). Above ``max_particles`` a strided
    particle subset is used (unbiased, higher variance — the same estimator
    contract as the g(r) subset)."""
    n = r_history.shape[1]
    if max_particles and n > max_particles:
        stride = n // max_particles
        r_history = r_history[:, :: stride][:, :max_particles]
    u = unwrap_trajectory(r_history, box)
    return _msd_device(u)


@jax.jit
def _msd_device(u: jax.Array) -> jax.Array:
    """All lags in ONE device program (an eager python loop would issue
    ~6 dispatches and small compiles per lag). Equal-shape lags via roll +
    origin masking keep it one small lax.map program."""
    s, n, _ = u.shape

    def lag(k):
        diff = jnp.roll(u, -k, axis=0) - u
        sq = jnp.sum(diff * diff, axis=-1)  # (s, n)
        valid = (jnp.arange(s) < s - k).astype(u.dtype)[:, None]
        return jnp.sum(sq * valid) / (jnp.maximum(s - k, 1) * n)

    return jax.lax.map(lag, jnp.arange(s))


def diffusion_coefficient(
    msd: jax.Array, dt_sample: float, dim: int
) -> Tuple[jax.Array, jax.Array]:
    """Einstein-relation fit ``MSD = 2 d D t + c`` over the second half of
    the MSD curve (skips the ballistic/crossover regime). Returns
    ``(D, slope_residual_rms)`` — the residual is a linearity diagnostic
    (large means the window is not yet diffusive)."""
    s = msd.shape[0]
    k0 = s // 2
    t = jnp.arange(k0, s, dtype=msd.dtype) * dt_sample
    y = msd[k0:]
    tm, ym = jnp.mean(t), jnp.mean(y)
    slope = jnp.sum((t - tm) * (y - ym)) / jnp.maximum(
        jnp.sum((t - tm) ** 2, ), 1e-30
    )
    resid = y - (ym + slope * (t - tm))
    d_coef = slope / (2.0 * dim)
    return d_coef, jnp.sqrt(jnp.mean(resid**2))

"""Workload: N-body black-hole merger with GW waveform + Lyapunov exponent.

Reference: nbody_bh_merger_sim_single-host_workload.py (289 LoC) — RK4 over a
lax.scan, then *host NumPy* post-processing for the GW strain (:147-171) and a
second full trajectory for the Lyapunov exponent (:175-208).

Redesign:
- pairwise gravity is vectorized (the reference unrolls a double Python loop,
  :54-67 — O(n^2) trace size);
- GW strain is computed on device (ops.observables.gw);
- Lyapunov defaults to the tangent-space (variational) method propagated by
  ``jax.jvp`` inside one scan — one device program instead of two full
  trajectories; the reference's two-trajectory estimator is kept as an option.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from jax_tpus_benchmark_physics_simulation_tpu.core.config import NBodyConfig
from jax_tpus_benchmark_physics_simulation_tpu.ops.forces import Gravity
from jax_tpus_benchmark_physics_simulation_tpu.ops.integrators import rk4_step_fn
from jax_tpus_benchmark_physics_simulation_tpu.ops.observables import (
    gw_strain,
    lyapunov_tangent,
    lyapunov_two_trajectory,
)


def init_state_flat(cfg: NBodyConfig) -> jax.Array:
    """Reference ICs (nbody...:99-108): bodies on a ring of diameter
    ``initial_distance`` with tangential velocities; flat layout
    ``[x0, y0, vx0, vy0, x1, ...]`` exactly as the reference builds it,
    then converted to our ``[pos..., vel...]`` layout."""
    n = cfg.n_bodies
    pos = np.zeros((n, 2))
    vel = np.zeros((n, 2))
    for i in range(n):
        angle = 2 * np.pi * i / n
        pos[i] = [cfg.initial_distance * np.cos(angle) / 2, cfg.initial_distance * np.sin(angle) / 2]
        vel[i] = [-cfg.initial_velocity * np.sin(angle), cfg.initial_velocity * np.cos(angle)]
    return jnp.concatenate([jnp.asarray(pos).ravel(), jnp.asarray(vel).ravel()])


def make_ode(cfg: NBodyConfig, masses: jax.Array):
    """dy/dt for flat y = [pos (2n), vel (2n)] (reference layout nbody...:69-77)."""
    n = cfg.n_bodies
    gravity = Gravity(g=cfg.g, mode="min_distance")

    def ode(t, y):
        pos = y[: 2 * n].reshape(n, 2)
        vel = y[2 * n :].reshape(n, 2)
        acc = gravity.acceleration(pos, masses)
        return jnp.concatenate([vel.ravel(), acc.ravel()])

    return ode


@partial(jax.jit, static_argnums=(0,))
def simulate(cfg: NBodyConfig, y0: jax.Array, masses: jax.Array):
    """One device program emitting the full trajectory on the output grid.

    ``rk4``: fixed-step scan, arithmetic-identical to nbody...:79-97.
    ``dopri5``: adaptive embedded RK45 with PI step control inside the same
    program (resolves close encounters the reference's fixed step misses).
    Returns ``ys`` of shape (num_steps + 1, 4n) with y0 prepended.
    """
    ode = make_ode(cfg, masses)
    if cfg.integrator == "dopri5":
        from jax_tpus_benchmark_physics_simulation_tpu.ops.integrators_adaptive import (
            dopri5_integrate,
        )

        ts = jnp.linspace(0.0, cfg.sim_time, cfg.num_steps + 1)
        return dopri5_integrate(ode, y0, ts, rtol=cfg.rtol, atol=cfg.atol).ys

    dt = cfg.sim_time / cfg.num_steps
    step = rk4_step_fn(ode, dt)

    def body(y, i):
        y_new = step(y, i * dt)
        return y_new, y_new

    _, ys = lax.scan(body, y0, jnp.arange(cfg.num_steps))
    return jnp.concatenate([y0[None, :], ys], axis=0)


@partial(jax.jit, static_argnums=(0,))
def simulate_with_waveform(cfg: NBodyConfig, y0: jax.Array, masses: jax.Array):
    """Trajectory + on-device GW strain in a single program."""
    ys = simulate(cfg, y0, masses)
    n = cfg.n_bodies
    t = jnp.linspace(0.0, cfg.sim_time, cfg.num_steps + 1)
    positions_t = ys[:, : 2 * n].reshape(-1, n, 2)
    h_plus = gw_strain(t, positions_t, masses, cfg.d_gw_mpc, g=cfg.g, c=cfg.c)
    return ys, t, positions_t, h_plus


@partial(jax.jit, static_argnums=(0,))
def lyapunov(cfg: NBodyConfig, y0: jax.Array, masses: jax.Array, d0: float = 1e-6):
    """Largest Lyapunov exponent.

    ``tangent``: Benettin variational method in one scan (default).
    ``two_trajectory``: the reference estimator (nbody...:175-208), one extra
    trajectory from ``y0 + d0*e_0``.
    """
    dt = cfg.sim_time / cfg.num_steps
    ode = make_ode(cfg, masses)
    step = rk4_step_fn(ode, dt)

    if cfg.lyapunov_method == "tangent":
        return lyapunov_tangent(lambda y: step(y, 0.0), y0, cfg.num_steps, dt, d0=d0)

    ys = simulate(cfg, y0, masses)
    ys_pert = simulate(cfg, y0.at[0].add(d0), masses)
    t = jnp.linspace(0.0, cfg.sim_time, cfg.num_steps + 1)
    lyap, _ = lyapunov_two_trajectory(t, ys, ys_pert, d0=d0)
    return lyap


@dataclass
class NBodyResult:
    t: jax.Array  # (T,)
    positions: jax.Array  # (T, n, 2)
    trajectory_flat: jax.Array  # (T, 4n)
    h_plus: jax.Array  # (T,)
    lyapunov: Optional[float]
    sim_wall_s: float


def run(cfg: Optional[NBodyConfig] = None, ckpt_dir: Optional[str] = None) -> NBodyResult:
    """``ckpt_dir``: orbax-checkpoint the completed trajectory bundle — a
    re-run with the same dir restores it and skips the simulation entirely
    (re-plot / re-export without recompute; the resumability the reference
    lacks, SURVEY.md §5)."""
    cfg = cfg or NBodyConfig()
    masses = jnp.asarray(cfg.masses, dtype=jnp.float32)
    y0 = init_state_flat(cfg)

    restored = None
    fp = None
    if ckpt_dir is not None:
        from jax_tpus_benchmark_physics_simulation_tpu.ckpt import (
            config_fingerprint,
            latest_step,
            restore_checkpoint,
        )

        fp = config_fingerprint(cfg)
        if latest_step(ckpt_dir) == cfg.num_steps:
            n = cfg.n_bodies
            tmpl = dict(
                ys=jnp.zeros((cfg.num_steps + 1, 4 * n), jnp.float32),
                t=jnp.zeros((cfg.num_steps + 1,), jnp.float32),
                positions=jnp.zeros((cfg.num_steps + 1, n, 2), jnp.float32),
                h_plus=jnp.zeros((cfg.num_steps + 1,), jnp.float32),
                fp=jnp.zeros((), jnp.int32),
            )
            try:
                restored = restore_checkpoint(ckpt_dir, tmpl, cfg.num_steps)
            except Exception as exc:  # pre-fingerprint / foreign layout
                print(f"[ckpt] ignoring incompatible checkpoint in {ckpt_dir}: {exc}")
            if restored is not None and int(restored["fp"]) != fp:
                print(
                    f"[ckpt] config changed since checkpoint in {ckpt_dir} "
                    "(fingerprint mismatch) — recomputing instead of restoring"
                )
                restored = None

    if restored is not None:
        ys, t = restored["ys"], restored["t"]
        positions_t, h_plus = restored["positions"], restored["h_plus"]
        wall = 0.0
    else:
        # warmup compile (reference discipline, nbody...:117-121)
        out = simulate_with_waveform(cfg, y0, masses)
        jax.block_until_ready(out)

        t0 = time.perf_counter()
        ys, t, positions_t, h_plus = simulate_with_waveform(cfg, y0, masses)
        jax.block_until_ready(h_plus)
        wall = time.perf_counter() - t0
        if ckpt_dir is not None:
            from jax_tpus_benchmark_physics_simulation_tpu.ckpt import save_checkpoint

            save_checkpoint(
                ckpt_dir,
                cfg.num_steps,
                dict(ys=ys, t=t, positions=positions_t, h_plus=h_plus,
                     fp=jnp.asarray(fp, jnp.int32)),
            )

    lyap = None
    if cfg.compute_chaos:
        lyap = float(lyapunov(cfg, y0, masses))

    return NBodyResult(
        t=t,
        positions=positions_t,
        trajectory_flat=ys,
        h_plus=h_plus,
        lyapunov=lyap,
        sim_wall_s=wall,
    )

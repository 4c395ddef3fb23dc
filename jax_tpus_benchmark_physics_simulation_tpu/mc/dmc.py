"""Diffusion Monte Carlo with on-device branching.

Reference: ``dmc_step_body`` + single ``lax.scan`` at vmc_dmc...:238-280 (the
one fully device-fused driver in the reference — the pattern generalized
here). Per step: local energies -> weights exp(-(E_L - E_ref) dt) ->
sanitize -> resample (branching, population fixed) -> drift + diffusion move.

Changes from the reference: resampler is pluggable (systematic by default — the
reference's ``random.choice`` multinomial is kept as an option), walker
snapshots are emitted at a configurable stride instead of the full
(n_steps, n_walkers, dim) history, and the walker population can be SHARDED
over a device mesh (``walker_sharding=``): E_ref is the exact global mean
via ``psum`` while branching is shard-local systematic resampling with a
fixed per-shard population — the scalable replacement for the reference's
serial global multinomial (SURVEY.md §7 hard part; see run_dmc).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax, random
from jax.sharding import PartitionSpec as P

from jax_tpus_benchmark_physics_simulation_tpu.core.config import VMCDMCConfig
from jax_tpus_benchmark_physics_simulation_tpu.mc.resampling import RESAMPLERS


@dataclass
class DMCResult:
    walkers: jax.Array  # final ensemble (n_walkers, dim)
    energy_history: jax.Array  # E_ref per step, (n_steps,)
    walker_snapshots: Optional[jax.Array]  # (n_snaps, n_walkers, dim) or None

    def mean_energy(self, burn_in: int = 100):
        """Mean +- standard error after burn-in (vmc_dmc...:317-321)."""
        e = self.energy_history[burn_in:]
        return jnp.mean(e), jnp.std(e) / jnp.sqrt(e.shape[0])


def make_dmc_step(
    model,
    params,
    dt: float,
    resampler: str = "systematic",
    axis_name: Optional[str] = None,
    n_total: Optional[int] = None,
):
    """One DMC step: ``(walkers, key) -> ((walkers, key), E_ref)``.

    With ``axis_name`` the step is the shard-local body of a shard_map over
    that mesh axis: ``E_ref`` is the exact global mean (psum of the local
    energy sum over ``n_total`` walkers) and branching is shard-local —
    each shard resamples its own ``n_local`` walkers from its local weights
    (population fixed per shard, hence globally). Local branching is the
    standard distributed-QMC compromise: cross-shard weight imbalance is
    O(1/sqrt(n_local)) per step and unbiased in E_ref's estimate at
    equilibrium (tests/test_mc.py checks statistical parity vs the
    single-device resampler on the 8-device mesh).
    """
    resample = RESAMPLERS[resampler]

    def step(carry, _):
        walkers, key = carry
        n, dim = walkers.shape

        e_local = model.local_energy(params, walkers)
        if axis_name is None:
            e_ref = jnp.mean(e_local)
        else:
            e_ref = lax.psum(jnp.sum(e_local), axis_name) / n_total
        weights = jnp.exp(-(e_local - e_ref) * dt)

        key, k_resample, k_diffuse = random.split(key, 3)
        walkers = resample(k_resample, walkers, weights)

        drift = model.drift_force(params, walkers) * dt
        diffusion = random.normal(k_diffuse, (n, dim), dtype=walkers.dtype) * jnp.sqrt(dt)
        walkers = walkers + drift + diffusion

        return (walkers, key), e_ref

    return step


def _make_program(step, cfg: VMCDMCConfig):
    """Whole-run scan (reference pattern vmc_dmc...:275-280); returns
    ``(walkers, key) -> (walkers, e_hist, snaps-or-None)``."""
    snap_every = cfg.snapshot_every

    def program(walkers, key):
        if snap_every and 0 < snap_every <= cfg.n_dmc:
            n_outer = cfg.n_dmc // snap_every

            def outer(carry, _):
                carry, e_refs = lax.scan(step, carry, length=snap_every)
                return carry, (e_refs, carry[0])

            carry, (e_refs, snaps) = lax.scan(outer, (walkers, key), length=n_outer)
            e_hist = e_refs.reshape(-1)
            rem = cfg.n_dmc - n_outer * snap_every
            if rem:
                carry, e_tail = lax.scan(step, carry, length=rem)
                e_hist = jnp.concatenate([e_hist, e_tail])
            return carry[0], e_hist, snaps
        carry, e_hist = lax.scan(step, (walkers, key), length=cfg.n_dmc)
        return carry[0], e_hist, None

    return program


def run_dmc(
    model,
    params,
    walkers: jax.Array,
    key: jax.Array,
    cfg: VMCDMCConfig,
    walker_sharding=None,
) -> DMCResult:
    """Whole DMC run as one device program (reference pattern
    vmc_dmc...:275-280).

    ``walker_sharding``: optional ``NamedSharding`` splitting the walker axis
    over a device mesh. The run becomes a single shard_map program: local
    energies, moves, and branching stay shard-local (zero per-step collectives
    except one scalar psum for E_ref); each shard's RNG stream is decorrelated
    by folding in its mesh index. ``n_walkers`` must divide evenly over the
    mesh axis. E_ref history is bitwise-identical across shards (psum) and
    returned replicated.
    """
    if walker_sharding is None:
        step = make_dmc_step(model, params, cfg.dmc_dt, cfg.resampler)
        program = jax.jit(_make_program(step, cfg))
        walkers, e_hist, snaps = program(walkers, key)
        return DMCResult(walkers=walkers, energy_history=e_hist, walker_snapshots=snaps)

    mesh = walker_sharding.mesh
    spec = walker_sharding.spec
    axis = spec[0]
    assert axis is not None, "walker_sharding must shard axis 0 (the walkers)"
    n_total = walkers.shape[0]
    n_dev = mesh.shape[axis]
    assert n_total % n_dev == 0, (
        f"n_walkers={n_total} must divide over the {n_dev}-device '{axis}' axis"
    )

    step = make_dmc_step(
        model, params, cfg.dmc_dt, cfg.resampler, axis_name=axis, n_total=n_total
    )
    program = _make_program(step, cfg)

    def local_program(walkers_local, key):
        key = random.fold_in(key, lax.axis_index(axis))
        return program(walkers_local, key)

    wspec = P(axis)
    has_snaps = bool(cfg.snapshot_every) and 0 < cfg.snapshot_every <= cfg.n_dmc
    snap_spec = P(None, axis) if has_snaps else None
    sharded = jax.jit(
        jax.shard_map(
            local_program,
            mesh=mesh,
            in_specs=(wspec, P()),
            out_specs=(wspec, P(), snap_spec),
            check_vma=False,  # e_hist is replicated by construction (psum)
        )
    )
    walkers = jax.device_put(walkers, walker_sharding)
    walkers, e_hist, snaps = sharded(walkers, key)
    return DMCResult(walkers=walkers, energy_history=e_hist, walker_snapshots=snaps)

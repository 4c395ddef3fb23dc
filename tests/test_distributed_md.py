"""Distributed MD (ring force, 8 virtual devices) vs the local dense engine."""

import pytest

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

import jax
import jax.numpy as jnp
import numpy as np

from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu.core.runner import run_steps
from jax_tpus_benchmark_physics_simulation_tpu.core.state import ParticleState
from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu.parallel.distributed_md import (
    run_distributed_md,
)
from tests.helpers import lattice_positions


def test_matches_local_dense():
    cfg = override(
        MDConfig(), n=100, rho=0.4, dt=1e-3, cutoff=2.5,
        prod_steps=60, sample_every=20, force_impl="dense_xla",
    )
    box = cfg.box_size
    pos = jnp.mod(lattice_positions(cfg.n, box, seed=0), box)
    vel = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (cfg.n, 2))

    res = run_distributed_md(cfg, pos, vel)

    init_fn, step_fn, _ = lj_fluid.build_step(cfg)
    s = init_fn(ParticleState.create(pos, vel))
    s = jax.jit(lambda t: run_steps(step_fn, t, 60))(s)

    np.testing.assert_allclose(
        np.asarray(res.position), np.asarray(s.position), rtol=1e-3, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(res.velocity), np.asarray(s.velocity), rtol=1e-2, atol=1e-2
    )
    assert res.ke_history.shape == (3,)
    assert np.all(np.isfinite(np.asarray(res.ke_history)))
    # pe_history is a REAL per-sample ring-energy series: its last entry must
    # equal the dense oracle's energy at the final positions, and the series
    # must not be a broadcast constant.
    from jax_tpus_benchmark_physics_simulation_tpu.ops.forces import LennardJones

    lj = LennardJones(box=box, cutoff=cfg.cutoff)
    np.testing.assert_allclose(
        float(res.pe_history[-1]), float(lj.energy(res.position)), rtol=1e-4
    )
    assert res.pe_history.shape == (3,)
    assert len(set(np.asarray(res.pe_history).tolist())) > 1


def test_padding_particles_stay_inert():
    """N=50 on 8 devices: 6 padded slots must remain at rest."""
    cfg = override(
        MDConfig(), n=50, rho=0.3, dt=1e-3, cutoff=2.5,
        prod_steps=20, sample_every=10,
    )
    box = cfg.box_size
    pos = jnp.mod(lattice_positions(cfg.n, box, seed=2), box)
    vel = 0.1 * jax.random.normal(jax.random.PRNGKey(3), (cfg.n, 2))
    res = run_distributed_md(cfg, pos, vel)
    assert res.position.shape == (50, 2)
    assert np.all(np.isfinite(np.asarray(res.position)))

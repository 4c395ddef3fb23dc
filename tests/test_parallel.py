"""Multi-device tests on the 8-device virtual CPU mesh: ring force passes
must match the single-device dense oracles; sharded MC must match replicated
results. (The reference has zero cross-device communication to test —
SURVEY.md §2g; these cover the new capability.)"""

import pytest

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from jax_tpus_benchmark_physics_simulation_tpu.ops.forces import Gravity, LennardJones
from jax_tpus_benchmark_physics_simulation_tpu.parallel import (
    make_mesh,
    make_ring_gravity_accel,
    make_ring_lj_force,
    pad_to_multiple,
    shard_along,
)
from tests.helpers import lattice_positions


@pytest.fixture(scope="module")
def mesh():
    assert jax.device_count() == 8
    return make_mesh(8)


class TestRingLJ:
    def test_matches_dense_oracle(self, mesh):
        n, rho = 256, 0.5
        box = float(np.sqrt(n / rho))
        pos = jnp.mod(lattice_positions(n, box, seed=0), box)
        valid = jnp.ones((n,), dtype=bool)

        force = make_ring_lj_force(mesh, box=box)
        pos_sharded = jax.device_put(pos, shard_along(mesh))
        f = force(pos_sharded, jax.device_put(valid, shard_along(mesh)))
        f_ref = LennardJones(box=box).force(pos)
        np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), rtol=1e-4, atol=1e-4)

    def test_with_padding(self, mesh):
        """N not divisible by 8: pad with invalid particles."""
        n, rho = 100, 0.4
        box = float(np.sqrt(n / rho))
        pos = jnp.mod(lattice_positions(n, box, seed=1), box)
        n_pad = pad_to_multiple(n, 8)
        pos_p = jnp.concatenate([pos, jnp.zeros((n_pad - n, 2))])
        valid = jnp.arange(n_pad) < n

        force = make_ring_lj_force(mesh, box=box, cutoff=2.5)
        f = force(
            jax.device_put(pos_p, shard_along(mesh)),
            jax.device_put(valid, shard_along(mesh)),
        )
        f_ref = LennardJones(box=box, cutoff=2.5).force(pos)
        np.testing.assert_allclose(
            np.asarray(f)[:n], np.asarray(f_ref), rtol=1e-4, atol=1e-4
        )
        np.testing.assert_allclose(np.asarray(f)[n:], 0.0, atol=1e-6)

    def test_jit_compatible(self, mesh):
        n, box = 64, 12.0
        pos = jnp.mod(lattice_positions(n, box, seed=2), box)
        valid = jnp.ones((n,), dtype=bool)
        force = jax.jit(make_ring_lj_force(mesh, box=box))
        f1 = force(jax.device_put(pos, shard_along(mesh)), valid)
        f2 = force(jax.device_put(pos, shard_along(mesh)), valid)
        np.testing.assert_allclose(np.asarray(f1), np.asarray(f2))


class TestRingGravity:
    def test_matches_dense_oracle(self, mesh):
        n = 64
        key = jax.random.PRNGKey(3)
        pos = jax.random.normal(key, (n, 2)) * 10.0
        m = jnp.abs(jax.random.normal(jax.random.PRNGKey(4), (n,))) + 0.5

        accel = make_ring_gravity_accel(mesh, softening=0.1)
        a = accel(
            jax.device_put(pos, shard_along(mesh)),
            jax.device_put(m, shard_along(mesh)),
        )
        a_ref = Gravity(mode="plummer", softening=0.1).acceleration(pos, m)
        np.testing.assert_allclose(np.asarray(a), np.asarray(a_ref), rtol=1e-4, atol=1e-5)

    def test_mass_zero_padding(self, mesh):
        n, n_pad = 30, 32
        pos = jax.random.normal(jax.random.PRNGKey(5), (n, 2)) * 5.0
        m = jnp.ones((n,))
        pos_p = jnp.concatenate([pos, jnp.zeros((n_pad - n, 2))])
        m_p = jnp.concatenate([m, jnp.zeros((n_pad - n,))])

        accel = make_ring_gravity_accel(mesh, softening=0.05)
        a = accel(
            jax.device_put(pos_p, shard_along(mesh)),
            jax.device_put(m_p, shard_along(mesh)),
        )
        a_ref = Gravity(mode="plummer", softening=0.05).acceleration(pos, m)
        np.testing.assert_allclose(np.asarray(a)[:n], np.asarray(a_ref), rtol=1e-4, atol=1e-5)


class TestShardedMC:
    def test_vmc_walkers_sharded_matches_replicated(self, mesh):
        """GSPMD-sharded walkers produce identical physics (same PRNG stream
        regardless of placement with partitionable threefry)."""
        from jax_tpus_benchmark_physics_simulation_tpu.core.config import (
            VMCDMCConfig,
            override,
        )
        from jax_tpus_benchmark_physics_simulation_tpu.mc import (
            HarmonicOscillator,
            run_vmc,
        )

        cfg = override(
            VMCDMCConfig(), n_walkers=512, n_epochs=10, n_equil=5, epoch_chunk=10
        )
        model = HarmonicOscillator(dim=2)
        res_rep = run_vmc(model, cfg)
        res_shard = run_vmc(model, cfg, walker_sharding=shard_along(mesh))
        np.testing.assert_allclose(
            np.asarray(res_rep.energy_history),
            np.asarray(res_shard.energy_history),
            rtol=1e-5,
        )


class TestDistributedMDStep:
    def test_ring_verlet_step_matches_local(self, mesh):
        """A full Verlet step built on the ring force == local dense step."""
        from jax_tpus_benchmark_physics_simulation_tpu.core.state import ParticleState
        from jax_tpus_benchmark_physics_simulation_tpu.ops.integrators import (
            velocity_verlet,
        )
        from jax_tpus_benchmark_physics_simulation_tpu.ops.forces import wrap

        n, rho = 128, 0.4
        box = float(np.sqrt(n / rho))
        pos = jnp.mod(lattice_positions(n, box, seed=6), box)
        vel = 0.1 * jax.random.normal(jax.random.PRNGKey(7), (n, 2))
        valid = jnp.ones((n,), dtype=bool)

        ring_force = make_ring_lj_force(mesh, box=box)
        lj = LennardJones(box=box)

        def step_with(force_fn, r, v, steps=20, dt=1e-3):
            f = force_fn(r)
            for _ in range(steps):
                v_half = v + 0.5 * dt * f
                r = wrap(r + dt * v_half, box)
                f = force_fn(r)
                v = v_half + 0.5 * dt * f
            return r, v

        r_sharded = jax.device_put(pos, shard_along(mesh))
        r1, v1 = step_with(lambda r: ring_force(r, valid), r_sharded, vel)
        r2, v2 = step_with(lj.force, pos, vel)
        np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), rtol=1e-4, atol=1e-4)


class TestShardedDMC:
    """Walker-sharded DMC branching (mc/dmc.py run_dmc walker_sharding=):
    shard-local systematic resampling + one psum'd E_ref per step — the
    scalable replacement for the reference's serial global multinomial
    (vmc_dmc...:255-260, SURVEY.md §7 hard part)."""

    def test_statistics_match_single_device(self, mesh):
        """Sharded branching reproduces the single-device ground-state
        energy within combined error bars, with fixed population."""
        from jax_tpus_benchmark_physics_simulation_tpu.core.config import (
            VMCDMCConfig,
            override,
        )
        from jax_tpus_benchmark_physics_simulation_tpu.mc import (
            HarmonicOscillator,
            run_dmc,
        )

        cfg = override(
            VMCDMCConfig(), n_walkers=4000, n_dmc=400, dmc_dt=0.01, dim=3
        )
        model = HarmonicOscillator(dim=3)
        walkers = jax.random.normal(jax.random.PRNGKey(11), (cfg.n_walkers, 3))
        res_1dev = run_dmc(model, jnp.asarray(0.45), walkers, jax.random.PRNGKey(12), cfg)
        res_shard = run_dmc(
            model, jnp.asarray(0.45), walkers, jax.random.PRNGKey(12), cfg,
            walker_sharding=shard_along(mesh),
        )
        m1, e1 = res_1dev.mean_energy(burn_in=100)
        m2, e2 = res_shard.mean_energy(burn_in=100)
        # exact E_0 = 1.5; both must hit it, and each other, within error bars
        assert abs(float(m1) - 1.5) < 0.05, float(m1)
        assert abs(float(m2) - 1.5) < 0.05, float(m2)
        assert abs(float(m1) - float(m2)) < 4 * (float(e1) + float(e2))
        # population fixed, walkers land sharded
        assert res_shard.walkers.shape == (cfg.n_walkers, 3)
        assert len(res_shard.walkers.sharding.device_set) == 8

    def test_snapshots_and_e_hist_shapes(self, mesh):
        from jax_tpus_benchmark_physics_simulation_tpu.core.config import (
            VMCDMCConfig,
            override,
        )
        from jax_tpus_benchmark_physics_simulation_tpu.mc import (
            HarmonicOscillator,
            run_dmc,
        )

        cfg = override(
            VMCDMCConfig(), n_walkers=256, n_dmc=50, dim=2, snapshot_every=10
        )
        model = HarmonicOscillator(dim=2)
        walkers = jax.random.normal(jax.random.PRNGKey(13), (256, 2))
        res = run_dmc(
            model, jnp.asarray(0.5), walkers, jax.random.PRNGKey(14), cfg,
            walker_sharding=shard_along(mesh),
        )
        assert res.walker_snapshots.shape == (5, 256, 2)
        assert res.energy_history.shape == (50,)
        assert bool(jnp.all(jnp.isfinite(res.energy_history)))

    def test_pipeline_end_to_end_sharded(self, mesh):
        """quantum_oscillator.run with walker_sharding shards VMC AND DMC."""
        from jax_tpus_benchmark_physics_simulation_tpu.core.config import (
            VMCDMCConfig,
            override,
        )
        from jax_tpus_benchmark_physics_simulation_tpu.models import quantum_oscillator

        cfg = override(
            VMCDMCConfig(), n_walkers=1000, n_epochs=150, n_equil=10,
            n_dmc=150, dim=2, epoch_chunk=50,
        )
        res = quantum_oscillator.run(cfg, walker_sharding=shard_along(mesh))
        assert abs(res.vmc_alpha - 0.5) < 0.1
        mean, _ = res.dmc.mean_energy(burn_in=50)
        assert abs(float(mean) - 1.0) < 0.1  # E_0 = D/2 = 1.0 for dim=2

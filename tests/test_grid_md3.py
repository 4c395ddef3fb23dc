"""3D grid-resident MD engine: force parity vs the dense oracle, rebuild
correctness (migration vs sort oracle), trajectory parity vs dense, energy
conservation, violation detection, and the lj_fluid 3D 'grid' dispatch.

Mirror of tests/test_grid_md.py for the 3D engine
(ops/kernels/grid_md3.py, cell_force.py)."""

import pytest

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

import jax
import jax.numpy as jnp
import numpy as np

from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu.ops.forces import LennardJones
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3
from tests.helpers import lattice_positions


def setup(n=1000, rho=0.25, dt=1e-3, kt=0.5, seed=0, **gridkw):
    box = float((n / rho) ** (1.0 / 3.0))
    pos = jnp.mod(lattice_positions(n, box, dim=3, seed=seed), box)
    vel = np.sqrt(kt) * jax.random.normal(jax.random.PRNGKey(seed + 1), (n, 3))
    gf = make_cell_grid_fn(box, 2.5, n, dim=3)
    md = GridMD3(gf, dt=dt, **gridkw)
    return box, pos, vel, md


class TestGridMD3:
    def test_init_roundtrip(self):
        box, pos, vel, md = setup()
        gs = md.init(pos, vel)
        assert not bool(gs.overflow)
        np.testing.assert_allclose(np.asarray(md.positions(gs)), np.asarray(pos), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(md.velocities(gs)), np.asarray(vel), rtol=1e-6)

    def test_forces_match_dense_oracle(self):
        box, pos, vel, md = setup()
        gs = md.init(pos, vel)
        lj = LennardJones(box=box, cutoff=2.5)
        f_ref = np.asarray(lj.force(pos))
        f_grid = np.asarray(md.forces(gs))
        np.testing.assert_allclose(f_grid, f_ref, rtol=2e-4, atol=2e-4)

    def test_fixed_cadence_overrun_is_loud(self):
        """A cadence far past the skin/2 drift horizon must raise the
        violation flag (the fixed driver's only safety net — banned from
        being silent)."""
        box, pos, vel, md = setup(kt=2.0, dt=5e-3)
        gs = md.init(pos, vel)
        run = jax.jit(md.make_production_run_fixed(120, 60))
        out = run(gs)
        assert bool(out.overflow)

    def test_energy_matches_dense_oracle(self):
        box, pos, vel, md = setup()
        gs = md.init(pos, vel)
        lj = LennardJones(box=box, cutoff=2.5)
        e_ref = float(lj.energy(pos))
        e_grid = float(md.potential_energy(gs))
        np.testing.assert_allclose(e_grid, e_ref, rtol=1e-4)

    def test_matches_dense_trajectory(self):
        """Chunked 3D grid MD (migration rebuilds firing) == dense engine
        over 150 steps."""
        n, rho, dt = 1000, 0.25, 2e-3
        box, pos, vel, md = setup(n=n, rho=rho, dt=dt, kt=1.0)
        gs = md.init(pos, vel)
        chunk = md.make_chunk_step(10)
        gs = jax.jit(lambda s: jax.lax.fori_loop(0, 15, lambda i, t: chunk(t), s))(gs)
        assert not bool(gs.overflow)

        cfg = override(
            MDConfig(), n=n, rho=rho, dim=3, dt=dt, cutoff=2.5, force_impl="dense_xla"
        )
        from jax_tpus_benchmark_physics_simulation_tpu.core.runner import run_steps
        from jax_tpus_benchmark_physics_simulation_tpu.core.state import ParticleState

        init_fn, step_fn, _ = lj_fluid.build_step(cfg)
        s = init_fn(ParticleState.create(pos, vel))
        s = jax.jit(lambda t: run_steps(step_fn, t, 150))(s)

        np.testing.assert_allclose(
            np.asarray(md.positions(gs)), np.asarray(s.position), rtol=1e-3, atol=1e-3
        )

    def test_production_run_matches_chunk_driver(self):
        """Cond-free nested-while driver == chunked cond driver, per pid
        (3D twin of test_grid_md's parity test)."""
        box, pos, vel, md = setup(n=1000, dt=2e-3, kt=1.0)
        k, gate = 10, 0.25
        chunk = md.make_chunk_step(k, gate_frac=gate)
        run = md.make_production_run(200, k, gate_frac=gate)

        gs_c = jax.jit(
            lambda s: jax.lax.fori_loop(0, 20, lambda i, t: chunk(t), s)
        )(md.init(pos, vel))
        gs_p = jax.jit(run)(md.init(pos, vel))
        assert not bool(gs_c.overflow) and not bool(gs_p.overflow)

        pc = np.mod(np.asarray(md.positions(gs_c)), box)
        pp = np.mod(np.asarray(md.positions(gs_p)), box)
        d = np.abs(pc - pp)
        d = np.minimum(d, box - d)
        np.testing.assert_allclose(d, 0.0, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(md.velocities(gs_c)),
            np.asarray(md.velocities(gs_p)),
            atol=1e-6,
        )

    def test_migration_rebuild_matches_sort_rebuild(self):
        box, pos, vel, md = setup(seed=4)
        gs = md.init(pos, vel)
        for _ in range(30):
            gs = md.step_nocheck(gs)
        mig = md._rebuild_migrate(gs)
        srt = md._rebuild(gs)
        assert not bool(mig.overflow)
        np.testing.assert_allclose(
            np.asarray(md.positions(mig)), np.asarray(md.positions(srt)), rtol=1e-6
        )
        np.testing.assert_allclose(
            np.asarray(md.velocities(mig)), np.asarray(md.velocities(srt)), rtol=1e-6
        )
        # forces carried through the permutation match a fresh re-init
        fresh = md.init(md.positions(mig), md.velocities(mig))
        f_mig = np.sort(np.asarray((mig.fxg * mig.occ).reshape(-1)))
        f_new = np.sort(np.asarray((fresh.fxg * fresh.occ).reshape(-1)))
        np.testing.assert_allclose(f_mig, f_new, atol=1e-4)

    def test_energy_conservation(self):
        box, pos, vel, md = setup(n=1000, rho=0.2, dt=5e-4, kt=0.5)
        gs = md.init(pos, vel)
        chunk = md.make_chunk_step(20)
        e0 = float(md.kinetic_energy(gs) + md.potential_energy(gs))

        @jax.jit
        def run(s):
            return jax.lax.fori_loop(0, 50, lambda i, t: chunk(t), s)

        gs = run(gs)  # 1000 steps
        assert not bool(gs.overflow)
        e1 = float(md.kinetic_energy(gs) + md.potential_energy(gs))
        assert abs(e1 - e0) / abs(e0) < 5e-3, (e0, e1)

    def test_violation_flag_on_oversized_window(self):
        box, pos, vel, md = setup(n=1000, rho=0.25, dt=5e-3, kt=2.0)
        gs = md.init(pos, vel)
        chunk = md.make_chunk_step(500)  # 500 * vmax * 5e-3 >> skin/2
        gs = chunk(gs)
        assert bool(gs.overflow)

    def test_compensated_runs(self):
        box, pos, vel, md = setup(kt=0.5, compensated=True)
        gs = md.init(pos, vel)
        chunk = md.make_chunk_step(10)
        gs = jax.jit(lambda s: jax.lax.fori_loop(0, 5, lambda i, t: chunk(t), s))(gs)
        assert not bool(gs.overflow)
        assert np.all(np.isfinite(np.asarray(md.positions(gs))))

    def test_nan_state_trips_overflow(self):
        """Diverged physics (NaN positions, e.g. the reference's overlapping
        uniform init) must trip the violation flag, not sail past the NaN-
        poisoned displacement monitor."""
        box, pos, vel, md = setup()
        gs = md.init(pos, vel)
        gs = gs.replace(vxg=gs.vxg * jnp.nan)
        chunk = md.make_chunk_step(5)
        gs = chunk(gs)
        assert bool(gs.overflow)


class TestLJFluid3DGridDispatch:
    def test_auto_resolves_grid_in_3d(self):
        cfg = override(MDConfig(), n=100_000, rho=0.8, dim=3, cutoff=2.5)
        assert lj_fluid.resolve_impl(cfg) == "grid"

    def test_run_end_to_end_grid3(self):
        cfg = override(
            MDConfig(),
            n=1000,
            rho=0.25,
            dim=3,
            cutoff=2.5,
            force_impl="grid",
            init="lattice",
            eq_steps=50,
            prod_steps=100,
            sample_every=20,
            dt=1e-3,
        )
        res = lj_fluid.run(cfg)
        assert res.r_history.shape == (5, 1000, 3)
        assert np.all(np.isfinite(np.asarray(res.r_history)))
        assert res.energy_drift < 0.05

    def test_grid3_matches_cell_production(self):
        common = dict(
            n=1000, rho=0.25, dim=3, cutoff=2.5, init="lattice",
            eq_steps=30, prod_steps=60, sample_every=20, dt=1e-3,
        )
        cfg_g = override(MDConfig(), force_impl="grid", **common)
        cfg_c = override(MDConfig(), force_impl="cell", **common)
        state = lj_fluid.init_state(cfg_g)
        _, (_, ke_g, pe_g), ovf = lj_fluid.production(cfg_g, state)
        _, (_, ke_c, pe_c), _ = lj_fluid.production(cfg_c, state)
        assert not bool(ovf)
        np.testing.assert_allclose(np.asarray(ke_g), np.asarray(ke_c), rtol=1e-3)
        np.testing.assert_allclose(np.asarray(pe_g), np.asarray(pe_c), rtol=1e-3, atol=0.05)

"""Grid-resident MD engine: parity vs the dense engine path, rebuild
correctness (migration vs sort oracle), violation detection, and the
lj_fluid 'grid' dispatch."""

import jax
import jax.numpy as jnp
import numpy as np

from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD
from tests.helpers import lattice_positions


def setup(n=400, rho=0.5, dt=1e-3, kt=0.5, seed=0):
    box = float(np.sqrt(n / rho))
    pos = jnp.mod(lattice_positions(n, box, seed=seed), box)
    vel = np.sqrt(kt) * jax.random.normal(jax.random.PRNGKey(seed + 1), (n, 2))
    gf = make_cell_grid_fn(box, 2.5, n, dim=2)
    md = GridMD(gf, dt=dt)
    return box, pos, vel, md


class TestGridMD:
    def test_init_roundtrip(self):
        box, pos, vel, md = setup()
        gs = md.init(pos, vel)
        assert not bool(gs.overflow)
        np.testing.assert_allclose(np.asarray(md.positions(gs)), np.asarray(pos), rtol=1e-6)
        np.testing.assert_allclose(np.asarray(md.velocities(gs)), np.asarray(vel), rtol=1e-6)

    def test_matches_dense_trajectory(self):
        """Chunked grid MD (with migration rebuilds firing) == dense engine
        over 300 steps."""
        n, rho, dt = 400, 0.5, 2e-3
        box, pos, vel, md = setup(n=n, rho=rho, dt=dt, kt=1.0)
        gs = md.init(pos, vel)
        chunk = md.make_chunk_step(10)
        gs = jax.jit(lambda s: jax.lax.fori_loop(0, 30, lambda i, t: chunk(t), s))(gs)
        assert not bool(gs.overflow)

        cfg = override(
            MDConfig(), n=n, rho=rho, dt=dt, cutoff=2.5, force_impl="dense_xla"
        )
        from jax_tpus_benchmark_physics_simulation_tpu.core.state import ParticleState
        from jax_tpus_benchmark_physics_simulation_tpu.core.runner import run_steps

        init_fn, step_fn, _ = lj_fluid.build_step(cfg)
        s = init_fn(ParticleState.create(pos, vel))
        s = jax.jit(lambda t: run_steps(step_fn, t, 300))(s)

        np.testing.assert_allclose(
            np.asarray(md.positions(gs)), np.asarray(s.position), rtol=1e-3, atol=1e-3
        )

    def test_production_run_matches_chunk_driver(self):
        """The cond-free nested-while driver (make_production_run) is
        trajectory-identical to the chunked cond driver: same windows, same
        gate cadence, same rebuilds — only the trailing rebuild differs,
        which permutes slots but not per-pid physics."""
        n, dt = 400, 2e-3
        box, pos, vel, md = setup(n=n, rho=0.5, dt=dt, kt=1.0)
        k, gate = 10, 0.25
        chunk = md.make_chunk_step(k, gate_frac=gate)
        run = md.make_production_run(300, k, gate_frac=gate)

        gs_c = jax.jit(
            lambda s: jax.lax.fori_loop(0, 30, lambda i, t: chunk(t), s)
        )(md.init(pos, vel))
        gs_p = jax.jit(run)(md.init(pos, vel))
        assert not bool(gs_c.overflow) and not bool(gs_p.overflow)

        # per-pid positions (mod box: the trailing rebuild wraps coords)
        pc = np.mod(np.asarray(md.positions(gs_c)), box)
        pp = np.mod(np.asarray(md.positions(gs_p)), box)
        d = np.abs(pc - pp)
        d = np.minimum(d, box - d)  # periodic distance
        np.testing.assert_allclose(d, 0.0, atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(md.velocities(gs_c)),
            np.asarray(md.velocities(gs_p)),
            atol=1e-6,
        )

    def test_migration_rebuild_matches_sort_rebuild(self):
        box, pos, vel, md = setup(seed=4)
        gs = md.init(pos, vel)
        for _ in range(40):
            gs = md.step_nocheck(gs)
        mig = md._rebuild_migrate(gs)
        srt = md._rebuild(gs)
        assert not bool(mig.overflow)
        # same particle->cell assignment content (slot order may differ):
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
        box, pos, vel, md = setup(n=400, rho=0.4, dt=5e-4, kt=0.5)
        gs = md.init(pos, vel)
        chunk = md.make_chunk_step(20)
        e0 = float(md.kinetic_energy(gs) + md.potential_energy(gs))

        @jax.jit
        def run(s):
            return jax.lax.fori_loop(0, 100, lambda i, t: chunk(t), s)

        gs = run(gs)  # 2000 steps
        assert not bool(gs.overflow)
        e1 = float(md.kinetic_energy(gs) + md.potential_energy(gs))
        assert abs(e1 - e0) / abs(e0) < 5e-3, (e0, e1)

    def test_violation_flag_on_oversized_window(self):
        """A window far larger than the skin allows must trip the flag."""
        box, pos, vel, md = setup(n=400, rho=0.5, dt=5e-3, kt=2.0)
        gs = md.init(pos, vel)
        chunk = md.make_chunk_step(500)  # 500 * vmax * 5e-3 >> skin/2
        gs = chunk(gs)
        assert bool(gs.overflow)


class TestLJFluidGridDispatch:
    def test_run_end_to_end_grid(self):
        cfg = override(
            MDConfig(),
            n=400,
            rho=0.5,
            cutoff=2.5,
            force_impl="grid",
            init="lattice",
            eq_steps=100,
            prod_steps=200,
            sample_every=20,
            dt=1e-3,
        )
        res = lj_fluid.run(cfg)
        assert res.r_history.shape == (10, 400, 2)
        assert np.all(np.isfinite(np.asarray(res.r_history)))
        assert res.energy_drift < 0.05

    def test_grid_matches_dense_xla_production(self):
        common = dict(
            n=400, rho=0.5, cutoff=2.5, init="lattice",
            eq_steps=50, prod_steps=100, sample_every=20, dt=1e-3,
        )
        cfg_g = override(MDConfig(), force_impl="grid", **common)
        cfg_d = override(MDConfig(), force_impl="dense_xla", **common)
        state = lj_fluid.init_state(cfg_g)
        _, (_, ke_g, pe_g), ovf = lj_fluid.production(cfg_g, state)
        _, (_, ke_d, pe_d), _ = lj_fluid.production(cfg_d, state)
        assert not bool(ovf)
        np.testing.assert_allclose(np.asarray(ke_g), np.asarray(ke_d), rtol=1e-3)
        np.testing.assert_allclose(np.asarray(pe_g), np.asarray(pe_d), rtol=1e-3, atol=0.05)


class TestAutoChunkParams:
    """(window, gate) coupled sizing: the violation margin invariant
    k * dt * 8*sqrt(kt) <= (0.5 - gate) * skin must hold for every output,
    the gate is size-aware (high gate only pays when the rebuild dominates),
    and large dt falls back to lower gates instead of a zero-step window."""

    def _md(self, n=100_000, dt=1e-3):
        gf = make_cell_grid_fn(float(np.sqrt(n / 0.8)), 2.5, n, dim=2)
        return GridMD(gf, dt=dt)

    def test_margin_invariant(self):
        for n in (4000, 16384, 100_000):
            for dt in (1e-4, 1e-3, 2e-3, 5e-3, 2e-2):
                md = self._md(n=n, dt=dt)
                for kt in (0.25, 1.0, 2.0):
                    k, gate = md.auto_chunk_params(kt=kt)
                    assert k >= 1
                    if dt * 8.0 * kt**0.5 > 0.25 * md.skin:
                        # dt so large even one step overruns every gate's
                        # margin: the floor (1, 0.25) is returned and the
                        # runtime violation flag is the guard (tested in
                        # test_violation_flag_on_oversized_window)
                        assert (k, gate) == (1, 0.25)
                        continue
                    assert k * dt * 8.0 * kt**0.5 <= (0.5 - gate) * md.skin + 1e-12, (
                        n, dt, kt, k, gate
                    )

    def test_size_aware_gate(self):
        k_big, gate_big = self._md(n=100_000).auto_chunk_params(kt=1.0)
        k_small, gate_small = self._md(n=16384).auto_chunk_params(kt=1.0)
        assert gate_big == 0.40 and k_big == 4    # preferred gate at N >= 50k
        assert gate_small == 0.35 and k_small == 7  # preferred gate below

    def test_large_dt_fallback(self):
        k, gate = self._md(dt=2e-2).auto_chunk_params(kt=1.0)
        assert k == 1 and gate == 0.25  # margin cannot fit 1 step at high gates

"""Cell-dense (roll-based) force path vs the dense cutoff oracle."""

import pytest

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax_tpus_benchmark_physics_simulation_tpu.ops.forces import LennardJones
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn,
    make_lj_force_cell_dense,
)
from tests.helpers import lattice_positions


def setup(n=400, rho=0.4, cutoff=2.5, skin=0.4, seed=0, dim=2):
    box = float((n / rho) ** (1.0 / dim))
    pos = jnp.mod(lattice_positions(n, box, dim=dim, seed=seed), box)
    gf = make_cell_grid_fn(box, cutoff, n, dim=dim, skin=skin)
    return box, pos, gf


class TestCellDense:
    @pytest.mark.parametrize("rho", [0.2, 0.8])
    def test_forces_match_dense_oracle(self, rho):
        box, pos, gf = setup(rho=rho)
        assign = gf.build(pos)
        assert not bool(assign.overflow)
        force_fn = make_lj_force_cell_dense(gf)
        f = force_fn(pos, assign)
        f_ref = LennardJones(box=box, cutoff=2.5).force(pos)
        np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), rtol=1e-4, atol=1e-4)

    def test_energy_matches_dense_oracle(self):
        box, pos, gf = setup(seed=3)
        assign = gf.build(pos)
        force_fn = make_lj_force_cell_dense(gf)
        e = float(force_fn.energy(pos, assign))
        e_ref = float(LennardJones(box=box, cutoff=2.5).energy(pos))
        np.testing.assert_allclose(e, e_ref, rtol=1e-5)

    def test_3d(self):
        box, pos, gf = setup(n=343, rho=0.3, dim=3, seed=5)
        assign = gf.build(pos)
        assert not bool(assign.overflow)
        force_fn = make_lj_force_cell_dense(gf)
        f = force_fn(pos, assign)
        f_ref = LennardJones(box=box, cutoff=2.5).force(pos)
        np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), rtol=1e-4, atol=1e-4)

    def test_forces_correct_after_small_moves(self):
        """Assignment built at R0 remains exact for moves < skin/2."""
        box, pos, gf = setup(seed=7)
        assign = gf.build(pos)
        moved = jnp.mod(
            pos + 0.1 * jax.random.normal(jax.random.PRNGKey(1), pos.shape), box
        )
        force_fn = make_lj_force_cell_dense(gf)
        f = force_fn(moved, assign)
        f_ref = LennardJones(box=box, cutoff=2.5).force(moved)
        np.testing.assert_allclose(np.asarray(f), np.asarray(f_ref), rtol=1e-4, atol=1e-4)

    def test_overflow_detection(self):
        n = 64
        box = 20.0
        pos = jnp.ones((n, 2)) * 5.0 + 1e-2 * jax.random.normal(
            jax.random.PRNGKey(0), (n, 2)
        )
        gf = make_cell_grid_fn(box, 2.5, n, dim=2)
        assign = gf.build(pos)
        assert bool(assign.overflow)

    def test_rebuild_logic(self):
        box, pos, gf = setup()
        assign = gf.build(pos)
        assert not bool(gf.needs_rebuild(pos + 0.05, assign))
        assert bool(gf.needs_rebuild(jnp.mod(pos + 0.5, box), assign))

    def test_small_box_raises(self):
        with pytest.raises(ValueError):
            make_cell_grid_fn(5.0, 2.5, 16, dim=2)

    def test_jit_scan_hot_loop(self):
        box, pos, gf = setup(n=200)
        force_fn = make_lj_force_cell_dense(gf)
        assign = gf.build(pos)

        @jax.jit
        def run(pos, assign):
            def body(carry, _):
                p, a = carry
                a = gf.maybe_rebuild(p, a)
                f = force_fn(p, a)
                p = jnp.mod(p + 1e-4 * f, box)
                return (p, a), jnp.sum(f)

            return jax.lax.scan(body, (pos, assign), length=30)

        (p, a), fs = run(pos, assign)
        assert np.all(np.isfinite(np.asarray(fs)))

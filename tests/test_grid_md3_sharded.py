"""Sharded 3D grid MD (8-device CPU mesh) vs the single-device 3D engine."""

import pytest

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3
from jax_tpus_benchmark_physics_simulation_tpu.parallel.grid_md3_sharded import (
    ShardedGridMD3,
)
from jax_tpus_benchmark_physics_simulation_tpu.parallel.mesh import make_mesh


def lattice3(n, box, seed=0, noise=0.05):
    side = int(np.ceil(n ** (1 / 3)))
    xs = (jnp.arange(side) + 0.5) * (box / side)
    mesh = jnp.stack(jnp.meshgrid(xs, xs, xs, indexing="ij"), axis=-1).reshape(-1, 3)[:n]
    return mesh + noise * jax.random.normal(jax.random.PRNGKey(seed), mesh.shape)


def setup(n=2000, cutoff=2.5, skin=0.4, dt=1e-3, kt=0.5, p=8):
    """Box sized so cells_per_side is a multiple of p (8 -> cps=8)."""
    box = 8.05 * (cutoff + skin)
    rho = n / box**3
    pos = jnp.mod(lattice3(n, box), box)
    vel = np.sqrt(kt) * jax.random.normal(jax.random.PRNGKey(1), (n, 3))
    gf = make_cell_grid_fn(box, cutoff, n, dim=3, skin=skin, rho=rho)
    assert gf.cells_per_side % p == 0, gf.cells_per_side
    mesh = make_mesh(p, axis_name="x")
    local = GridMD3(gf, dt=dt)
    sharded = ShardedGridMD3(gf, mesh, dt=dt)
    return pos, vel, local, sharded


class TestSharded3Force:
    def test_force_matches_local(self):
        pos, vel, local, sharded = setup()
        gs = local.init(pos, vel)
        f_l = local.force_kernel(gs.xg, gs.yg, gs.zg)
        gss = sharded.shard_state(gs)
        f_s = sharded.force_once(gss)
        occ = np.asarray(gs.occ) > 0.5
        for a, b, name in zip(f_s, f_l, "xyz"):
            np.testing.assert_allclose(
                np.asarray(a)[occ], np.asarray(b)[occ], rtol=1e-4, atol=1e-4,
                err_msg=f"f{name}",
            )

    def test_energy_matches_local(self):
        pos, vel, local, sharded = setup()
        gs = local.init(pos, vel)
        gss = sharded.shard_state(gs)
        np.testing.assert_allclose(
            float(sharded.potential_energy(gss)),
            float(local.potential_energy(gs)),
            rtol=1e-5,
        )


class TestSharded3Trajectory:
    def test_chunked_run_matches_local(self):
        pos, vel, local, sharded = setup()
        gs_l = local.init(pos, vel)
        gs_s = sharded.shard_state(gs_l)

        chunk_l = local.make_chunk_step(10)
        chunk_s = sharded.make_chunk_step(10)

        @jax.jit
        def run_l(s):
            return jax.lax.fori_loop(0, 20, lambda i, t: chunk_l(t), s)

        @jax.jit
        def run_s(s):
            return jax.lax.fori_loop(0, 20, lambda i, t: chunk_s(t), s)

        out_l = run_l(gs_l)
        out_s = run_s(gs_s)
        assert not bool(out_l.overflow)
        assert not bool(out_s.overflow)

        p_l = np.asarray(local.positions(out_l))
        p_s = np.asarray(local.positions(out_s))  # same layout helpers apply
        np.testing.assert_allclose(p_s, p_l, rtol=1e-3, atol=1e-3)

        ke_l = float(local.kinetic_energy(out_l))
        ke_s = float(local.kinetic_energy(out_s))
        np.testing.assert_allclose(ke_s, ke_l, rtol=1e-3)

    def test_energy_conservation_sharded(self):
        pos, vel, local, sharded = setup(dt=5e-4)
        gs = sharded.shard_state(local.init(pos, vel))
        e0 = float(local.kinetic_energy(gs) + local.potential_energy(gs))
        chunk = sharded.make_chunk_step(20)

        @jax.jit
        def run(s):
            return jax.lax.fori_loop(0, 25, lambda i, t: chunk(t), s)

        gs = run(gs)  # 500 steps with rebuilds crossing shard boundaries
        assert not bool(gs.overflow)
        e1 = float(local.kinetic_energy(gs) + local.potential_energy(gs))
        assert abs(e1 - e0) / abs(e0) < 5e-3

    def test_mesh_size_must_divide(self):
        pos, vel, local, _ = setup()
        with pytest.raises(ValueError):
            ShardedGridMD3(local.grid_fn, make_mesh(3, axis_name="x"))

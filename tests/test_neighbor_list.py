"""Neighbor-list correctness: forces/energies must match the dense cutoff
oracle exactly (same pairs), rebuild logic, overflow detection, small boxes."""

import pytest

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax_tpus_benchmark_physics_simulation_tpu.ops.forces import LennardJones
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.neighbor_list import (
    make_lj_force_neighbor,
    make_neighbor_fn,
)
from tests.helpers import lattice_positions


def setup(n=400, rho=0.8, cutoff=2.5, skin=0.4, seed=0, jitter=0.05):
    box = float(np.sqrt(n / rho))
    pos = lattice_positions(n, box, seed=seed, jitter=jitter)
    pos = jnp.mod(pos, box)
    nf = make_neighbor_fn(box, cutoff, n, dim=2, skin=skin)
    return box, pos, nf


class TestBuild:
    def test_forces_match_dense_cutoff_oracle(self):
        box, pos, nf = setup()
        nbrs = nf.build(pos)
        assert not bool(nbrs.overflow)
        force_fn = make_lj_force_neighbor(nf)
        f_nbr = force_fn(pos, nbrs)
        f_dense = LennardJones(box=box, cutoff=2.5).force(pos)
        np.testing.assert_allclose(
            np.asarray(f_nbr), np.asarray(f_dense), rtol=1e-4, atol=1e-5
        )

    def test_energy_matches_dense_cutoff_oracle(self):
        box, pos, nf = setup(seed=2)
        nbrs = nf.build(pos)
        force_fn = make_lj_force_neighbor(nf)
        e_nbr = float(force_fn.energy(pos, nbrs))
        e_dense = float(LennardJones(box=box, cutoff=2.5).energy(pos))
        np.testing.assert_allclose(e_nbr, e_dense, rtol=1e-5)

    def test_neighbor_sets_match_bruteforce(self):
        """The (unordered) neighbor sets equal brute-force r < rc + skin."""
        box, pos, nf = setup(n=100)
        nbrs = nf.build(pos)
        idx = np.asarray(nbrs.idx)
        pos_np = np.asarray(pos)
        n = pos_np.shape[0]
        dr = pos_np[:, None, :] - pos_np[None, :, :]
        dr -= box * np.round(dr / box)
        r2 = (dr**2).sum(-1)
        rc2 = (2.5 + 0.4) ** 2
        for i in range(n):
            expected = set(np.nonzero((r2[i] < rc2) & (np.arange(n) != i))[0].tolist())
            got = set(int(j) for j in idx[i] if j < n)
            assert got == expected, (i, got ^ expected)

    def test_small_box_wraparound_no_duplicates(self):
        """cells_per_side < 3: wrap-around offsets must not duplicate pairs."""
        n = 16
        box = 4.0  # cutoff+skin = 2.9 -> 1 cell per side
        pos = jnp.mod(lattice_positions(n, box, jitter=0.02, seed=4), box)
        nf = make_neighbor_fn(box, 2.5, n, dim=2, skin=0.4)
        assert nf.cells_per_side == 1
        nbrs = nf.build(pos)
        force_fn = make_lj_force_neighbor(nf)
        f_nbr = force_fn(pos, nbrs)
        f_dense = LennardJones(box=box, cutoff=2.5).force(pos)
        np.testing.assert_allclose(
            np.asarray(f_nbr), np.asarray(f_dense), rtol=1e-4, atol=1e-4
        )

    def test_overflow_detection(self):
        """All particles in one spot must trip the overflow flag."""
        n = 64
        box = 20.0
        pos = jnp.ones((n, 2)) * 5.0 + 1e-3 * jax.random.normal(
            jax.random.PRNGKey(0), (n, 2)
        )
        nf = make_neighbor_fn(box, 2.5, n, dim=2, skin=0.4, rho=n / box**2)
        nbrs = nf.build(pos)
        assert bool(nbrs.overflow)

    def test_3d(self):
        n, rho, cutoff = 216, 0.5, 2.5
        box = float((n / rho) ** (1 / 3))
        pos = jnp.mod(lattice_positions(n, box, dim=3, seed=6), box)
        nf = make_neighbor_fn(box, cutoff, n, dim=3, skin=0.4)
        nbrs = nf.build(pos)
        assert not bool(nbrs.overflow)
        force_fn = make_lj_force_neighbor(nf)
        f_nbr = force_fn(pos, nbrs)
        f_dense = LennardJones(box=box, cutoff=cutoff).force(pos)
        np.testing.assert_allclose(
            np.asarray(f_nbr), np.asarray(f_dense), rtol=1e-4, atol=1e-4
        )


class TestRebuild:
    def test_no_rebuild_for_small_moves(self):
        box, pos, nf = setup()
        nbrs = nf.build(pos)
        moved = pos + 0.05  # < skin/2 = 0.2
        assert not bool(nf.needs_rebuild(moved, nbrs))
        nbrs2 = nf.maybe_rebuild(moved, nbrs)
        np.testing.assert_array_equal(np.asarray(nbrs2.idx), np.asarray(nbrs.idx))

    def test_rebuild_for_large_moves(self):
        box, pos, nf = setup()
        nbrs = nf.build(pos)
        moved = jnp.mod(pos + 0.3, box)  # > skin/2
        assert bool(nf.needs_rebuild(moved, nbrs))
        nbrs2 = nf.maybe_rebuild(moved, nbrs)
        np.testing.assert_allclose(np.asarray(nbrs2.ref_position), np.asarray(moved))

    def test_forces_correct_within_skin(self):
        """List built at R0 still gives exact forces after moves < skin/2."""
        box, pos, nf = setup(seed=8)
        nbrs = nf.build(pos)
        key = jax.random.PRNGKey(1)
        moved = jnp.mod(pos + 0.15 * jax.random.normal(key, pos.shape) / jnp.sqrt(2.0), box)
        # clamp per-particle displacement below skin/2
        force_fn = make_lj_force_neighbor(nf)
        f_nbr = force_fn(moved, nbrs)
        f_dense = LennardJones(box=box, cutoff=2.5).force(moved)
        np.testing.assert_allclose(
            np.asarray(f_nbr), np.asarray(f_dense), rtol=1e-4, atol=1e-4
        )

    def test_jit_scan_with_rebuilds(self):
        """maybe_rebuild composes with lax.scan (the MD hot loop pattern)."""
        box, pos, nf = setup(n=64)
        force_fn = make_lj_force_neighbor(nf)
        nbrs = nf.build(pos)

        @jax.jit
        def run(pos, nbrs):
            def body(carry, _):
                p, nb = carry
                nb = nf.maybe_rebuild(p, nb)
                f = force_fn(p, nb)
                p = jnp.mod(p + 1e-4 * f, box)
                return (p, nb), jnp.sum(f)

            (p, nb), fs = jax.lax.scan(body, (pos, nbrs), length=50)
            return p, nb, fs

        p, nb, fs = run(pos, nbrs)
        assert np.all(np.isfinite(np.asarray(fs)))
        assert not bool(nb.overflow)

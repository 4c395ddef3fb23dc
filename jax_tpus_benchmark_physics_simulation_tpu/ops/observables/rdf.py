"""Radial distribution function g(r), fully on device.

Reference: ``_calculate_g_r_internal`` at molecular_dynamics...:108-131
(per-snapshot O(N^2) distances + ``jnp.histogram`` over ``triu_indices``,
vmapped over snapshots, normalized by ideal-gas shell counts).

Design:
- For large systems the dense (N, N) distance matrix cannot exist (40 GB at
  N = 100k); g(r) is estimated from a fixed random subset of particles
  (``max_particles``), which is an unbiased estimator of the same g(r) with
  slightly higher variance — the subset's own pair density normalizes it.
- Two histogram algorithms, chosen by compute shape:
  * comparison-based (counts[b] = #(r2 < edge[b+1]^2) - #(r2 < edge[b]^2)):
    pure compare+reduce, no scatters — fastest when nbins is modest;
  * bucketize + scatter-add: O(pairs) when nbins is large (wide boxes make
    nbins ~ box / (2 dr) in the thousands, where the comparison method's
    O(nbins * pairs) explodes).
Both match the reference histogram exactly on identical inputs
(tests/test_md.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from jax_tpus_benchmark_physics_simulation_tpu.ops.forces.pbc import pair_displacements

# max elements of the (nbins, pairs) comparison block before switching to the
# scatter-based histogram
_COMPARE_BUDGET = 2 * 10**9
# default particle-subset cap: 4096^2 pair distances = 64 MB, always safe
_DEFAULT_MAX_PARTICLES = 4096


@partial(jax.jit, static_argnums=(2, 4, 5))
def radial_distribution(
    r_history: jax.Array,  # (S, N, dim)
    box: jax.Array | float,
    nbins: int,
    r_max: jax.Array | float,
    dim: int = 2,
    max_particles: int = _DEFAULT_MAX_PARTICLES,
):
    """Returns ``(bin_centers, g_r)``, each shape (nbins,)."""
    s, n, _ = r_history.shape

    if n > max_particles:
        # fixed, seed-stable random subset (NOT a stride: particle order can
        # be spatially correlated, e.g. lattice inits)
        perm = jax.random.permutation(jax.random.PRNGKey(0), n)[:max_particles]
        r_history = r_history[:, perm, :]
        n = max_particles

    r_bins = jnp.linspace(0.0, r_max, nbins + 1)
    bin_centers = 0.5 * (r_bins[:-1] + r_bins[1:])
    if dim == 2:
        shell = jnp.pi * (r_bins[1:] ** 2 - r_bins[:-1] ** 2)
    elif dim == 3:
        shell = (4.0 / 3.0) * jnp.pi * (r_bins[1:] ** 3 - r_bins[:-1] ** 3)
    else:
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    rho_pairs = (n * (n - 1) / 2.0) / (box**dim)
    ideal_counts = rho_pairs * shell

    iu = jnp.triu(jnp.ones((n, n), dtype=bool), k=1)
    use_compare = (nbins + 1) * n * n <= _COMPARE_BUDGET

    def snapshot_hist(r_snap):
        dr = pair_displacements(r_snap, box)
        r2 = jnp.sum(dr * dr, axis=-1)
        if use_compare:
            r2 = jnp.where(iu, r2, jnp.inf).ravel()
            edges2 = r_bins * r_bins  # monotone: compare in r^2, no sqrt
            below = jnp.sum(r2[None, :] < edges2[:, None], axis=1).astype(jnp.float32)
            return below[1:] - below[:-1]
        # Uniform edges (linspace) -> the bin index is pure arithmetic:
        # floor(r / bin_w), the same answer as searchsorted's binary-search
        # rounds (~9 gather passes over the pair set) at one single-column
        # scatter-add.
        bin_w = r_max / nbins
        r = jnp.sqrt(r2)
        idx = jnp.minimum((r / bin_w).astype(jnp.int32), nbins)
        idx = jnp.where(iu & (r < r_max), idx, nbins)
        counts = jnp.zeros((nbins + 1,), jnp.float32).at[idx.ravel()].add(1.0)
        return counts[:nbins]

    # Sequential over snapshots, accumulated in place: batching would
    # materialize an O(S * nbins * n^2) (compare) or O(S * n^2) (bucketize)
    # intermediate.
    def body(i, acc):
        return acc + snapshot_hist(r_history[i])

    total = jax.lax.fori_loop(0, s, body, jnp.zeros((nbins,), jnp.float32))
    g_r = (total / s) / ideal_counts
    return bin_centers, g_r

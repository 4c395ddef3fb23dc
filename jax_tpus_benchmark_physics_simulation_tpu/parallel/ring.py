"""Ring pairwise-force pass: the multi-chip O(N^2) interaction.

The reference cannot compute interacting forces across devices at all (its
pmap use is embarrassingly parallel, SURVEY.md §2g). This is the answer of
SURVEY.md §5 ("sequence parallelism of this domain"): shard particles over
the mesh; each of P devices holds N/P particles; rotate a copy of the shard
around the device ring with ``lax.ppermute`` for P rounds, accumulating
partial forces each round — ring attention's dataflow applied to forces.
Compute is O(N^2 / P) per device, memory O(N / P), and the permute overlaps
with the pair-block compute under XLA's async collectives.

Padding convention: N must be divisible by the ring size; pad with particles
flagged invalid via ``valid`` masks (mass 0 works for gravity, valid=False
for LJ).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from jax_tpus_benchmark_physics_simulation_tpu.ops.forces.pbc import minimum_image


def _lj_block(ri, rj, valid_i, valid_j, *, sigma, epsilon, box, cutoff, same_shard):
    """Forces on block i from block j, (n_i, D). Masks handle padding/self."""
    dr = ri[:, None, :] - rj[None, :, :]
    if box is not None:
        dr = minimum_image(dr, box)
    r2 = jnp.sum(dr * dr, axis=-1)
    mask = valid_i[:, None] & valid_j[None, :]
    if same_shard:
        n = ri.shape[0]
        mask = mask & ~jnp.eye(n, dtype=bool)
    else:
        # distinct shards can still hold identical padded coords; r2 > 0 guard
        mask = mask & (r2 > 1e-12)
    if cutoff is not None:
        mask = mask & (r2 < cutoff**2)
    r2_safe = jnp.where(mask, r2, 1.0)
    inv_r2 = (sigma * sigma) / r2_safe
    s6 = inv_r2 * inv_r2 * inv_r2
    s12 = s6 * s6
    fmag = jnp.where(mask, 24.0 * epsilon * (2.0 * s12 - s6) / r2_safe, 0.0)
    return jnp.sum(fmag[..., None] * dr, axis=1)


def _gravity_block(ri, rj, mj, *, g, softening2, same_shard):
    """Acceleration on block i from block j. Padding carries mass 0 and thus
    exerts nothing; coincident points are guarded by the r2 floor."""
    dr = rj[None, :, :] - ri[:, None, :]  # toward j
    r2 = jnp.sum(dr * dr, axis=-1) + softening2
    mask = r2 > 1e-12
    if same_shard:
        n = ri.shape[0]
        mask = mask & ~jnp.eye(n, dtype=bool)
    r2_safe = jnp.where(mask, r2, 1.0)
    inv_r3 = r2_safe ** (-1.5)
    amag = jnp.where(mask, g * mj[None, :] * inv_r3, 0.0)
    return jnp.sum(amag[..., None] * dr, axis=1)


def make_ring_lj_force(
    mesh: Mesh,
    axis_name: str = "d",
    sigma: float = 1.0,
    epsilon: float = 1.0,
    box: Optional[float] = None,
    cutoff: Optional[float] = None,
):
    """Returns ``force(R, valid) -> F`` as a shard_map program: R ``(N, D)``
    sharded on dim 0, valid ``(N,)`` bool sharded likewise; F sharded like R.
    """
    p = mesh.shape[axis_name]

    def local(r_local, valid_local):
        blk = partial(
            _lj_block, sigma=sigma, epsilon=epsilon, box=box, cutoff=cutoff
        )
        f0 = blk(r_local, r_local, valid_local, valid_local, same_shard=True)

        def round_fn(carry, k):
            other_r, other_v, acc = carry
            other_r = lax.ppermute(
                other_r, axis_name, [(i, (i + 1) % p) for i in range(p)]
            )
            other_v = lax.ppermute(
                other_v, axis_name, [(i, (i + 1) % p) for i in range(p)]
            )
            acc = acc + blk(r_local, other_r, valid_local, other_v, same_shard=False)
            return (other_r, other_v, acc), None

        if p > 1:
            (_, _, f), _ = lax.scan(
                round_fn, (r_local, valid_local, f0), jnp.arange(p - 1)
            )
        else:
            f = f0
        return f

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(axis_name),
    )


def _lj_energy_block(ri, rj, valid_i, valid_j, *, sigma, epsilon, box, cutoff, same_shard):
    """Per-particle (i-side) LJ energies from block j, (n_i,). Shifted so
    U(cutoff) = 0 when a cutoff is set — same convention as
    forces.LennardJones._shift, so ring PE matches the dense oracle."""
    dr = ri[:, None, :] - rj[None, :, :]
    if box is not None:
        dr = minimum_image(dr, box)
    r2 = jnp.sum(dr * dr, axis=-1)
    mask = valid_i[:, None] & valid_j[None, :]
    if same_shard:
        n = ri.shape[0]
        mask = mask & ~jnp.eye(n, dtype=bool)
    else:
        mask = mask & (r2 > 1e-12)
    shift = 0.0
    if cutoff is not None:
        mask = mask & (r2 < cutoff**2)
        sc6 = (sigma / cutoff) ** 6
        shift = 4.0 * epsilon * (sc6 * sc6 - sc6)
    r2_safe = jnp.where(mask, r2, 1.0)
    inv_r2 = (sigma * sigma) / r2_safe
    s6 = inv_r2 * inv_r2 * inv_r2
    s12 = s6 * s6
    pair = jnp.where(mask, 4.0 * epsilon * (s12 - s6) - shift, 0.0)
    return jnp.sum(pair, axis=1)


def make_ring_lj_energy(
    mesh: Mesh,
    axis_name: str = "d",
    sigma: float = 1.0,
    epsilon: float = 1.0,
    box: Optional[float] = None,
    cutoff: Optional[float] = None,
):
    """Returns ``energy(R, valid) -> scalar`` (replicated) as a shard_map
    program: total potential energy via the same ring rotation as the force
    pass, psum-reduced. Each pair is seen by both endpoints, hence the 0.5."""
    p = mesh.shape[axis_name]

    def local(r_local, valid_local):
        blk = partial(
            _lj_energy_block, sigma=sigma, epsilon=epsilon, box=box, cutoff=cutoff
        )
        e0 = blk(r_local, r_local, valid_local, valid_local, same_shard=True)

        def round_fn(carry, k):
            other_r, other_v, acc = carry
            perm = [(i, (i + 1) % p) for i in range(p)]
            other_r = lax.ppermute(other_r, axis_name, perm)
            other_v = lax.ppermute(other_v, axis_name, perm)
            acc = acc + blk(r_local, other_r, valid_local, other_v, same_shard=False)
            return (other_r, other_v, acc), None

        if p > 1:
            (_, _, e), _ = lax.scan(
                round_fn, (r_local, valid_local, e0), jnp.arange(p - 1)
            )
        else:
            e = e0
        return lax.psum(0.5 * jnp.sum(e), axis_name)

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(),
    )


def make_ring_gravity_accel(
    mesh: Mesh,
    axis_name: str = "d",
    g: float = 1.0,
    softening: float = 0.0,
):
    """Returns ``accel(R, masses) -> A`` sharded on dim 0. Padding particles
    must carry mass 0 (they then exert no force; their own acceleration is
    garbage but masked by the caller)."""
    p = mesh.shape[axis_name]
    softening2 = float(softening) ** 2

    def local(r_local, m_local):
        blk = partial(_gravity_block, g=g, softening2=softening2)
        a0 = blk(r_local, r_local, m_local, same_shard=True)

        def round_fn(carry, k):
            other_r, other_m, acc = carry
            perm = [(i, (i + 1) % p) for i in range(p)]
            other_r = lax.ppermute(other_r, axis_name, perm)
            other_m = lax.ppermute(other_m, axis_name, perm)
            acc = acc + blk(r_local, other_r, other_m, same_shard=False)
            return (other_r, other_m, acc), None

        if p > 1:
            (_, _, a), _ = lax.scan(
                round_fn, (r_local, m_local, a0), jnp.arange(p - 1)
            )
        else:
            a = a0
        return a

    return jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(axis_name),
    )

"""Cell-list + Verlet neighbor-list machinery (fixed capacity, jit-static
shapes) — the O(N) force path the reference lacks entirely (SURVEY.md §5
"Long-context": the reference's scaling wall is the dense O(N^2) pair matrix;
this is the cutoff structure that removes it).

Design (sort-based — no dynamic shapes anywhere):
1. bin particles into cells of side >= cutoff + skin (cell id per particle);
2. argsort by cell id; rank-within-cell = position - segment start
   (via searchsorted over the sorted ids);
3. scatter sorted particle indices into a (n_cells, cell_capacity) table
   (sentinel N, overflow detected and reported, never silently dropped);
4. per particle, gather the 3^dim neighboring cells' occupants as candidates
   (offsets deduplicated modulo the grid so small boxes stay correct);
5. compact candidates to a (N, K) neighbor array by a stable argsort on the
   validity mask (runs only at rebuild, amortized over ~skin/2 / (v dt) steps).

A Verlet skin makes the list reusable: it is valid until some particle moves
more than skin/2 from its build-time reference position.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax_tpus_benchmark_physics_simulation_tpu.utils import struct

from jax_tpus_benchmark_physics_simulation_tpu.ops.forces.pbc import minimum_image


@struct.dataclass
class NeighborList:
    idx: jax.Array  # (N, K) int32 neighbor indices, sentinel = N
    ref_position: jax.Array  # (N, D) positions at build time
    overflow: jax.Array  # bool: any capacity exceeded at any build so far

    @property
    def capacity(self) -> int:
        return self.idx.shape[1]


@struct.dataclass
class NeighborFn:
    """Bundle of (static) build parameters + pure build/update functions."""

    box: float = struct.field(pytree_node=False)
    cutoff: float = struct.field(pytree_node=False)
    skin: float = struct.field(pytree_node=False)
    n: int = struct.field(pytree_node=False)
    dim: int = struct.field(pytree_node=False)
    cells_per_side: int = struct.field(pytree_node=False)
    cell_capacity: int = struct.field(pytree_node=False)
    k_max: int = struct.field(pytree_node=False)

    # -- cell binning ------------------------------------------------------
    def _cell_ids(self, position: jax.Array) -> jax.Array:
        cps = self.cells_per_side
        cell_size = self.box / cps
        coords = jnp.clip((position // cell_size).astype(jnp.int32), 0, cps - 1)
        flat = coords[:, 0]
        for d in range(1, self.dim):
            flat = flat * cps + coords[:, d]
        return flat

    def _neighbor_cell_offsets(self) -> jax.Array:
        """Deduplicated wrap-around-safe offsets of the 3^dim neighborhood."""
        cps = self.cells_per_side
        base = sorted(set((o % cps) for o in (-1, 0, 1)))
        grids = jnp.meshgrid(*([jnp.asarray(base, dtype=jnp.int32)] * self.dim), indexing="ij")
        return jnp.stack([g.ravel() for g in grids], axis=1)  # (n_off, dim)

    # -- build -------------------------------------------------------------
    def build(self, position: jax.Array, prev_overflow=None) -> NeighborList:
        n, dim, cps = self.n, self.dim, self.cells_per_side
        n_cells = cps**dim
        cap = self.cell_capacity

        ids = self._cell_ids(position)  # (N,)
        order = jnp.argsort(ids)
        sorted_ids = ids[order]
        seg_start = jnp.searchsorted(sorted_ids, sorted_ids, side="left")
        rank = jnp.arange(n, dtype=jnp.int32) - seg_start.astype(jnp.int32)
        cell_overflow = jnp.any(rank >= cap)
        rank = jnp.minimum(rank, cap - 1)

        slots = jnp.full((n_cells, cap), n, dtype=jnp.int32)
        slots = slots.at[sorted_ids, rank].set(order.astype(jnp.int32))

        # candidate gather: neighbor cells of each particle's cell
        coords = jnp.clip(
            (position // (self.box / cps)).astype(jnp.int32), 0, cps - 1
        )  # (N, dim)
        offsets = self._neighbor_cell_offsets()  # (n_off, dim)
        nbr_coords = (coords[:, None, :] + offsets[None, :, :]) % cps  # (N, n_off, dim)
        nbr_flat = nbr_coords[..., 0]
        for d in range(1, dim):
            nbr_flat = nbr_flat * cps + nbr_coords[..., d]
        cand = slots[nbr_flat].reshape(n, -1)  # (N, n_off * cap)

        # validity: real particle, not self, within cutoff + skin
        i_ids = jnp.arange(n, dtype=jnp.int32)[:, None]
        pos_pad = jnp.concatenate([position, jnp.zeros((1, dim), position.dtype)])
        dr = minimum_image(position[:, None, :] - pos_pad[cand], self.box)
        r2 = jnp.sum(dr * dr, axis=-1)
        rc2 = (self.cutoff + self.skin) ** 2
        valid = (cand != n) & (cand != i_ids) & (r2 < rc2)

        # compact to K: stable sort brings valid candidates to the front
        perm = jnp.argsort(~valid, axis=1, stable=True)
        k = self.k_max
        idx = jnp.take_along_axis(cand, perm[:, :k], axis=1)
        valid_k = jnp.take_along_axis(valid, perm[:, :k], axis=1)
        idx = jnp.where(valid_k, idx, n)

        nbr_overflow = jnp.any(jnp.sum(valid, axis=1) > k)
        overflow = cell_overflow | nbr_overflow
        if prev_overflow is not None:
            overflow = overflow | prev_overflow
        return NeighborList(idx=idx, ref_position=position, overflow=overflow)

    def needs_rebuild(self, position: jax.Array, nbrs: NeighborList) -> jax.Array:
        dr = minimum_image(position - nbrs.ref_position, self.box)
        max_disp2 = jnp.max(jnp.sum(dr * dr, axis=-1))
        return max_disp2 > (0.5 * self.skin) ** 2

    def maybe_rebuild(self, position: jax.Array, nbrs: NeighborList) -> NeighborList:
        return jax.lax.cond(
            self.needs_rebuild(position, nbrs),
            lambda p, nb: self.build(p, prev_overflow=nb.overflow),
            lambda p, nb: nb,
            position,
            nbrs,
        )


def make_neighbor_fn(
    box: float,
    cutoff: float,
    n: int,
    dim: int = 2,
    skin: float = 0.4,
    rho: Optional[float] = None,
    cell_capacity: Optional[int] = None,
    k_max: Optional[int] = None,
    safety: float = 1.75,
) -> NeighborFn:
    """Size the static capacities from density (overridable). Overflow is
    surfaced on the NeighborList, so undersized capacities fail loudly."""
    cells_per_side = max(1, int(box / (cutoff + skin)))
    cell_size = box / cells_per_side
    if rho is None:
        rho = n / (box**dim)
    if cell_capacity is None:
        mean_per_cell = rho * cell_size**dim
        cell_capacity = max(4, int(math.ceil(mean_per_cell * safety + 4)))
    if k_max is None:
        if dim == 2:
            ball = math.pi * (cutoff + skin) ** 2
        else:
            ball = 4.0 / 3.0 * math.pi * (cutoff + skin) ** 3
        k_max = max(8, int(math.ceil(rho * ball * safety + 8)))
    # round K up to a lane-friendly multiple
    k_max = ((k_max + 7) // 8) * 8
    return NeighborFn(
        box=float(box),
        cutoff=float(cutoff),
        skin=float(skin),
        n=n,
        dim=dim,
        cells_per_side=cells_per_side,
        cell_capacity=cell_capacity,
        k_max=k_max,
    )


def make_lj_force_neighbor(
    neighbor_fn: NeighborFn,
    sigma: float = 1.0,
    epsilon: float = 1.0,
):
    """Returns ``force_fn(R, nbrs) -> F`` — O(N*K) gather-based LJ forces with
    the energy shift at the cutoff (same physics as
    ``LennardJones(box=..., cutoff=...)``, cross-checked in tests)."""
    n, dim, box, cutoff = neighbor_fn.n, neighbor_fn.dim, neighbor_fn.box, neighbor_fn.cutoff

    def force_fn(position: jax.Array, nbrs: NeighborList) -> jax.Array:
        pos_pad = jnp.concatenate([position, jnp.zeros((1, dim), position.dtype)])
        rn = pos_pad[nbrs.idx]  # (N, K, D)
        dr = minimum_image(position[:, None, :] - rn, box)
        r2 = jnp.sum(dr * dr, axis=-1)
        mask = (nbrs.idx < n) & (r2 < cutoff**2)
        r2_safe = jnp.where(mask, r2, 1.0)
        inv_r2 = (sigma * sigma) / r2_safe
        s6 = inv_r2 * inv_r2 * inv_r2
        s12 = s6 * s6
        fmag = jnp.where(mask, 24.0 * epsilon * (2.0 * s12 - s6) / r2_safe, 0.0)
        return jnp.sum(fmag[..., None] * dr, axis=1)

    def energy_fn(position: jax.Array, nbrs: NeighborList) -> jax.Array:
        sc6 = (sigma / cutoff) ** 6
        shift = 4.0 * epsilon * (sc6 * sc6 - sc6)
        pos_pad = jnp.concatenate([position, jnp.zeros((1, dim), position.dtype)])
        rn = pos_pad[nbrs.idx]
        dr = minimum_image(position[:, None, :] - rn, box)
        r2 = jnp.sum(dr * dr, axis=-1)
        mask = (nbrs.idx < n) & (r2 < cutoff**2)
        r2_safe = jnp.where(mask, r2, 1.0)
        inv_r2 = (sigma * sigma) / r2_safe
        s6 = inv_r2 * inv_r2 * inv_r2
        pair = jnp.where(mask, 4.0 * epsilon * (s6 * s6 - s6) - shift, 0.0)
        return 0.5 * jnp.sum(pair)

    force_fn.energy = energy_fn
    return force_fn

"""Cell-dense LJ forces: regular cell-grid compute with ``jnp.roll`` —
zero gathers in the hot loop.

Here particles are binned into a dense
``(ncx, ncy, capacity)`` grid; each of the 3^dim neighbor cells is brought
adjacent by ``jnp.roll`` (a regular copy XLA pipelines at HBM speed, which
also implements periodic wrap-around for free), and every cell-vs-cell
(C x C) pair block is dense elementwise work. Per step:

1. scatter positions into the cell grid at precomputed slots (one (N,)
   row-scatter — slots are static between rebuilds, Verlet-skin semantics);
2. for each offset: roll, minimum-image, LJ on the (ncells, C, C) block;
3. gather per-slot forces back to particle order (one (N,) row-gather).

The binning (argsort by cell id) runs only on rebuild, ~every skin/2 / (v dt)
steps. Capacity overflow is detected and surfaced, never silent.
"""

from __future__ import annotations

import itertools
import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax_tpus_benchmark_physics_simulation_tpu.utils import struct

from jax_tpus_benchmark_physics_simulation_tpu.ops.forces.pbc import minimum_image


@struct.dataclass
class CellAssignment:
    slot: jax.Array  # (N,) int32 flat slot index into the cell grid
    occupancy: jax.Array  # (*grid, C) bool
    ref_position: jax.Array  # (N, D) positions at build time
    overflow: jax.Array  # bool


@struct.dataclass
class CellGridFn:
    box: float = struct.field(pytree_node=False)
    cutoff: float = struct.field(pytree_node=False)
    skin: float = struct.field(pytree_node=False)
    n: int = struct.field(pytree_node=False)
    dim: int = struct.field(pytree_node=False)
    cells_per_side: int = struct.field(pytree_node=False)
    capacity: int = struct.field(pytree_node=False)

    @property
    def n_cells(self) -> int:
        return self.cells_per_side**self.dim

    def _cell_coords(self, position: jax.Array) -> jax.Array:
        cps = self.cells_per_side
        return jnp.clip((position // (self.box / cps)).astype(jnp.int32), 0, cps - 1)

    def build(self, position: jax.Array, prev_overflow=None) -> CellAssignment:
        n, cap, cps, dim = self.n, self.capacity, self.cells_per_side, self.dim
        coords = self._cell_coords(position)
        ids = coords[:, 0]
        for d in range(1, dim):
            ids = ids * cps + coords[:, d]

        order = jnp.argsort(ids)
        sorted_ids = ids[order]
        seg_start = jnp.searchsorted(sorted_ids, sorted_ids, side="left")
        rank = jnp.arange(n, dtype=jnp.int32) - seg_start.astype(jnp.int32)
        overflow = jnp.any(rank >= cap)
        rank = jnp.minimum(rank, cap - 1)
        if prev_overflow is not None:
            overflow = overflow | prev_overflow

        # slot of particle p (in original order)
        slot_sorted = sorted_ids * cap + rank
        slot = jnp.zeros((n,), dtype=jnp.int32).at[order].set(slot_sorted)

        occ_flat = jnp.zeros((self.n_cells * cap,), dtype=bool).at[slot].set(True)
        occupancy = occ_flat.reshape((cps,) * dim + (cap,))
        return CellAssignment(
            slot=slot, occupancy=occupancy, ref_position=position, overflow=overflow
        )

    def needs_rebuild(self, position: jax.Array, assign: CellAssignment) -> jax.Array:
        dr = minimum_image(position - assign.ref_position, self.box)
        return jnp.max(jnp.sum(dr * dr, axis=-1)) > (0.5 * self.skin) ** 2

    def maybe_rebuild(self, position: jax.Array, assign: CellAssignment) -> CellAssignment:
        return jax.lax.cond(
            self.needs_rebuild(position, assign),
            lambda p, a: self.build(p, prev_overflow=a.overflow),
            lambda p, a: a,
            position,
            assign,
        )


def make_cell_grid_fn(
    box: float,
    cutoff: float,
    n: int,
    dim: int = 2,
    skin: float = 0.4,
    rho: Optional[float] = None,
    capacity: Optional[int] = None,
    safety: Optional[float] = None,
) -> CellGridFn:
    cells_per_side = max(1, int(box / (cutoff + skin)))
    if cells_per_side < 3:
        raise ValueError(
            f"cell-dense path needs >= 3 cells per side (box={box}, "
            f"cutoff+skin={cutoff + skin}); use the dense or neighbor path"
        )
    cell_size = box / cells_per_side
    if rho is None:
        rho = n / (box**dim)
    if capacity is None:
        mean = rho * cell_size**dim
        if safety is not None:
            capacity = max(4, int(math.ceil(mean * safety + 2)))
        else:
            # mean + 3*sqrt(mean) + 1 (Poisson tail), rounded up to a
            # multiple of 8 below: the GPU force kernel tiles the slot axis
            # in 8-slot chunks (cell_triton.SLOT_TILE), so no tile straddles
            # two cells.
            capacity = max(4, int(math.ceil(mean + 3.0 * math.sqrt(mean) + 1)))
    capacity = ((capacity + 7) // 8) * 8  # whole 8-slot kernel tiles
    return CellGridFn(
        box=float(box),
        cutoff=float(cutoff),
        skin=float(skin),
        n=n,
        dim=dim,
        cells_per_side=cells_per_side,
        capacity=capacity,
    )


def make_lj_force_cell_dense(
    grid_fn: CellGridFn,
    sigma: float = 1.0,
    epsilon: float = 1.0,
):
    """Returns ``force_fn(R, assign) -> F`` (and ``force_fn.energy``):
    identical physics to ``LennardJones(box, cutoff)`` — cross-checked in
    tests/test_cell_dense.py."""
    n, dim, box, cutoff, cap = (
        grid_fn.n,
        grid_fn.dim,
        grid_fn.box,
        grid_fn.cutoff,
        grid_fn.capacity,
    )
    cps = grid_fn.cells_per_side
    grid_shape = (cps,) * dim
    offsets = list(itertools.product((-1, 0, 1), repeat=dim))
    axes = tuple(range(dim))
    sc6 = (sigma / cutoff) ** 6
    shift = 4.0 * epsilon * (sc6 * sc6 - sc6)

    def _pair_blocks(position: jax.Array, assign: CellAssignment):
        """Yields per-offset (dr, valid) on the (grid..., C, C) pair block."""
        flat = jnp.zeros((grid_fn.n_cells * cap, dim), position.dtype)
        pos_c = flat.at[assign.slot].set(position).reshape(grid_shape + (cap, dim))
        occ = assign.occupancy
        eye = jnp.eye(cap, dtype=bool)
        for off in offsets:
            other = jnp.roll(pos_c, off, axis=axes) if any(off) else pos_c
            occ_o = jnp.roll(occ, off, axis=axes) if any(off) else occ
            dr = minimum_image(
                pos_c[..., :, None, :] - other[..., None, :, :], box
            )  # (grid..., C, C, D)
            r2 = jnp.sum(dr * dr, axis=-1)
            valid = occ[..., :, None] & occ_o[..., None, :] & (r2 < cutoff**2)
            if not any(off):
                valid = valid & ~eye
            yield pos_c, dr, r2, valid

    def force_fn(position: jax.Array, assign: CellAssignment) -> jax.Array:
        f_c = None
        for pos_c, dr, r2, valid in _pair_blocks(position, assign):
            r2_safe = jnp.where(valid, r2, 1.0)
            inv_r2 = (sigma * sigma) / r2_safe
            s6 = inv_r2 * inv_r2 * inv_r2
            s12 = s6 * s6
            fmag = jnp.where(valid, 24.0 * epsilon * (2.0 * s12 - s6) / r2_safe, 0.0)
            contrib = jnp.sum(fmag[..., None] * dr, axis=-2)  # (grid..., C, D)
            f_c = contrib if f_c is None else f_c + contrib
        return f_c.reshape(-1, dim)[assign.slot]

    def energy_fn(position: jax.Array, assign: CellAssignment) -> jax.Array:
        e = jnp.zeros((), position.dtype)
        for _, _, r2, valid in _pair_blocks(position, assign):
            r2_safe = jnp.where(valid, r2, 1.0)
            inv_r2 = (sigma * sigma) / r2_safe
            s6 = inv_r2 * inv_r2 * inv_r2
            pair = jnp.where(valid, 4.0 * epsilon * (s6 * s6 - s6) - shift, 0.0)
            e = e + 0.5 * jnp.sum(pair)
        return e

    force_fn.energy = energy_fn
    return force_fn

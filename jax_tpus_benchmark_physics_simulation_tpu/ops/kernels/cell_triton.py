"""Pallas cell-grid LJ force kernel for NVIDIA GPUs (Triton route), 2D and 3D.

Same layout, interface and ``.raw`` contract as ``cell_force`` (read its
module doc first); this is the ``"triton"`` implementation.

Each program owns a tile of ``A`` slots x ``T`` lanes (cells) of one cell
row ``i``: the self tile ``S`` of row ``i`` and the tile ``N`` of the next
row at the same place. Their coordinates and force sums stay in registers
while a loop walks the partner slots ``b < max_occ`` (the runtime maximum
cell occupancy, loaded from a ``(1,)`` int32 operand). For every partner
slot and every lane offset ``o`` of the ``3^(d-1)`` neighbour cells in a
row, the program loads the partner coordinates of row ``i`` and of row
``i+1`` at lanes ``l + o`` (offset loads with a modular index; wrapped cells
get ``+-box``) and accumulates

- the force on ``S`` from row ``i`` and from row ``i+1``;
- the force on ``N`` from row ``i``: the reaction of the next-row pairs,
  returned unshifted as ``.raw``'s reaction output.

So each pair with the next row is computed twice (once per side) and no
program writes another's outputs: there is no cross-block accumulation.
That is the full neighbour shell, about twice the pair math of the Newton
halving the plain version uses, traded for a kernel with no reaction
scatter. The pair math is ``cell_force.lj_pair``, shared with the plain
version. Slot chunks with ``a0 >= max_occ`` hold only sentinels and just
store zeros.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_force import (
    fold_reactions,
    half_shell,
    lane_dims,
    lj_pair,
    lj_params,
)

# Tile of one program: SLOT_TILE slots x LANE_TILE cells (powers of two, as
# Triton requires). Capacities are multiples of SLOT_TILE (cell_dense), so
# slot tiles never straddle two cells.
SLOT_TILE = 8
LANE_TILE = 32
NUM_WARPS = 4


def _kernel(mo_ref, *refs, dim, dims, cap, box, n_rows, row_wrap,
            with_energy, prm):
    n_in = 2 * dim
    xs_refs, xn_refs = refs[0:n_in:2], refs[1:n_in:2]
    out_refs = refs[n_in:]
    i = pl.program_id(0)
    a0 = pl.program_id(1) * SLOT_TILE
    t0 = pl.program_id(2) * LANE_TILE
    n_lanes = math.prod(dims)
    lanes = t0 + jnp.arange(LANE_TILE, dtype=jnp.int32)
    live = lanes < n_lanes
    tile = (SLOT_TILE, LANE_TILE)
    mo = jnp.minimum(mo_ref[0], cap)

    if row_wrap:  # neighbour row of the same grid, across the seam at the end
        row_n = (i + 1) % n_rows
        x_wrap = (i == n_rows - 1).astype(jnp.float32) * box
    else:
        row_n, x_wrap = i, None

    def store_all(vals):
        for ref, v in zip(out_refs, vals):
            plgpu.store(
                ref.at[i, pl.ds(a0, SLOT_TILE), pl.ds(t0, LANE_TILE)],
                v, mask=live[None, :],
            )

    @pl.when(a0 >= mo)
    def _():
        store_all([jnp.zeros(tile, jnp.float32)] * len(out_refs))

    @pl.when(a0 < mo)
    def _():
        def self_tile(ref, row):
            return plgpu.load(
                ref.at[row, pl.ds(a0, SLOT_TILE), pl.ds(t0, LANE_TILE)],
                mask=live[None, :], other=0.0,
            )

        s = [self_tile(r, i) for r in xs_refs]
        src_n = xs_refs if row_wrap else xn_refs
        n = [self_tile(r, row_n) for r in src_n]
        if x_wrap is not None:
            n[0] = n[0] + x_wrap

        # partner lanes and seam offsets of every neighbour cell, per lane
        # (dead lanes wrap to valid indices; their results are not stored)
        cell = []
        rest = lanes
        for k in reversed(range(len(dims))):
            cell.insert(0, rest % dims[k])
            rest = rest // dims[k]
        offsets = []
        for o in half_shell(len(dims))[1]:
            idx = jnp.zeros_like(lanes)
            delta = []
            for k, (d, nk) in enumerate(zip(o, dims)):
                c = cell[k] + d
                idx = idx * nk + (c + nk) % nk
                wrapped = (c >= nk).astype(jnp.float32) - (c < 0).astype(jnp.float32)
                delta.append(wrapped * box if d else None)
            offsets.append((idx, delta))

        n_acc = dim + 2 * with_energy
        zero = jnp.zeros(tile, jnp.float32)

        def pair_terms(self_c, part_c):
            dr = [sc - pc[None, :] for sc, pc in zip(self_c, part_c)]
            r2 = sum(d * d for d in dr)
            valid = (r2 < prm["cutoff2"]) & (r2 > 0.0)
            fmag, e, w = lj_pair(r2, valid, with_energy=with_energy, **prm)
            return [fmag * d for d in dr] + ([e, w] if with_energy else [])

        def body(b, carry):
            acc_s, acc_n = carry
            acc_s, acc_n = list(acc_s), list(acc_n)
            for idx, delta in offsets:
                ps, pn = [], []
                for c in range(dim):
                    vs = plgpu.load(xs_refs[c].at[i, b, idx])
                    vn = plgpu.load(src_n[c].at[row_n, b, idx])
                    if c >= 1 and delta[c - 1] is not None:
                        vs = vs + delta[c - 1]
                        vn = vn + delta[c - 1]
                    ps.append(vs)
                    pn.append(vn)
                if x_wrap is not None:
                    pn[0] = pn[0] + x_wrap
                for t in (pair_terms(s, ps), pair_terms(s, pn)):
                    acc_s = [a + v for a, v in zip(acc_s, t)]
                acc_n = [a + v for a, v in zip(acc_n, pair_terms(n, ps))]
            return tuple(acc_s), tuple(acc_n)

        init = ((zero,) * n_acc, (zero,) * n_acc)
        acc_s, acc_n = jax.lax.fori_loop(0, mo, body, init)
        out = list(acc_s[:dim]) + list(acc_n[:dim])
        if with_energy:
            out += [acc_s[dim], acc_n[dim], acc_s[dim + 1], acc_n[dim + 1]]
        store_all(out)


def make_triton_force(
    grid_fn: CellGridFn,
    sigma: float = 1.0,
    epsilon: float = 1.0,
    with_energy: bool = False,
    n_rows: Optional[int] = None,
    interpret: bool = False,
):
    """Triton-route grid force (see module doc and ``cell_force``)."""
    dim, cap = grid_fn.dim, grid_fn.capacity
    dims = lane_dims(grid_fn)
    assert cap % SLOT_TILE == 0, (cap, SLOT_TILE)
    n_lanes = math.prod(dims)
    full_rows = grid_fn.cells_per_side
    n_out = 2 * dim + 4 * with_energy

    def build(rows, row_wrap):
        kernel = functools.partial(
            _kernel, dim=dim, dims=dims, cap=cap, box=float(grid_fn.box),
            n_rows=rows, row_wrap=row_wrap, with_energy=with_energy,
            prm=lj_params(grid_fn, sigma, epsilon),
        )
        out = jax.ShapeDtypeStruct((rows, cap, n_lanes), jnp.float32)
        return pl.pallas_call(
            kernel,
            out_shape=[out] * n_out,
            grid=(rows, cap // SLOT_TILE, pl.cdiv(n_lanes, LANE_TILE)),
            compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
            backend="triton",
            interpret=interpret,
            name=f"lj_cell_force{dim}d" + ("_energy" if with_energy else ""),
        )

    def mo_arr(max_occ):
        if max_occ is None:
            return jnp.full((1,), cap, jnp.int32)
        return jnp.asarray(max_occ, jnp.int32).reshape((1,))

    fused = build(full_rows, row_wrap=True)
    raw_call = build(full_rows if n_rows is None else n_rows, row_wrap=False)

    def grid_force(*coords, max_occ=None):
        args = [v for c in coords for v in (c, c)]
        out = fused(mo_arr(max_occ), *args)
        return fold_reactions(out, dim, with_energy)

    def raw(*args, max_occ=None):
        return tuple(raw_call(mo_arr(max_occ), *args))

    grid_force.raw = raw
    grid_force.impl = "triton"
    return grid_force

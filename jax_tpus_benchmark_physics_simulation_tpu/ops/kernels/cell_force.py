"""Cell-grid LJ forces on the grid-resident layout (2D and 3D).

Layout: the cell grid is stored as ``(ncx, C, L)``: cell rows along x,
``C`` slots per cell, and the remaining cell axes flattened into ``L``
(``L = ncy`` in 2D; ``L = ncy*ncz`` in 3D, lane ``cy*ncz + cz``). Empty
slots hold the x sentinel ``SENTINEL_FACTOR*box`` (grid_md), so the validity
test ``0 < r2 < cutoff^2`` rejects every pair that touches one: no
occupancy masks. Between rebuilds a particle stays within one cell of its
assigned cell, so pair displacements are already minimal except across the
periodic seams, which are handled once per block by adding ``+-box`` to the
wrapped partner coordinates: no per-pair minimum-image rounding.

Two implementations compute the same physics behind one interface:

- ``plain``: Newton's-third-law pair blocks over the whole grid in
  ``jax.numpy`` (``jnp.roll`` brings neighbour cells adjacent). Same-row
  offsets fold their reaction back in-row; next-row offsets return it as a
  per-row reaction output. This is XLA's candidate, the per-layout
  reference of the kernel, and what runs on the CPU.
- ``triton``: the Pallas kernel of ``cell_triton`` (GPU only).

:func:`choose_impl` picks one from the platform; :func:`make_grid_force`
builds it. The pair math (:func:`lj_pair`) is shared by both.

Interface: ``grid_force(x, y[, z], max_occ=None) -> (fx, fy[, fz])``, or
``(..., e, w)`` with ``with_energy=True`` (per-slot pair energy and virial,
each pair counted on both partners). ``grid_force.raw(xs, xn, ys, yn[, zs,
zn], max_occ=None)`` works on ``n_rows`` local rows with explicit
next-row arrays (the sharded engines build them from halos, with the
periodic ``+box`` x-adjustment applied on the seam device) and returns
``(f..., rf...[, e, re, w, rw])``, where reaction row ``i`` is destined for
row ``i+1`` and is left unshifted: the caller owns the shift, which crosses
devices when sharded. ``max_occ`` bounds the occupied slots of every cell
(slots are compacted to the low indices); the plain version ignores it.

Physics: the reference's LJ 6-12 (molecular_dynamics_jax_single-host_
workload.py:50-62) with a shifted cutoff, cross-checked against the dense
oracle in tests/test_cell_force.py.
"""

from __future__ import annotations

import itertools
from typing import Optional

import jax
import jax.numpy as jnp

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import CellGridFn

# Force implementation the GPU runs; see PERF.md for the on-card timings
# that chose it.
GPU_IMPL = "triton"
IMPLS = ("plain", "triton")


def choose_impl(platform: Optional[str] = None) -> str:
    """The force implementation for ``platform`` (default: JAX's backend):
    the measured-faster one on a GPU, the plain version elsewhere."""
    if platform is None:
        platform = jax.default_backend()
    return GPU_IMPL if platform == "gpu" else "plain"


def lane_dims(grid_fn: CellGridFn) -> tuple:
    """Cell counts of the axes flattened into the lane axis."""
    return (grid_fn.cells_per_side,) * (grid_fn.dim - 1)


def lj_params(grid_fn: CellGridFn, sigma: float, epsilon: float) -> dict:
    sc6 = (sigma / grid_fn.cutoff) ** 6
    return dict(
        cutoff2=float(grid_fn.cutoff) ** 2,
        sigma2=float(sigma) ** 2,
        epsilon=float(epsilon),
        shift=float(4.0 * epsilon * (sc6 * sc6 - sc6)),
    )


def lj_pair(r2, valid, *, sigma2, epsilon, shift, with_energy, **_):
    """Shifted-cutoff LJ pair terms. Returns ``(fmag, e, w)``: the force on
    particle i is ``fmag * (r_i - r_j)``, ``e`` the pair energy and ``w``
    the pair virial ``r . f`` (``None`` without energy). Invalid pairs give
    exact zeros (``where`` does not propagate the inf/NaN of ``r2 = 0``).
    The division is the route's own: IEEE under XLA, Triton's approximate
    ``div.full`` (2 ulp) in the kernel; on the card the two agree as well
    as a refined reciprocal does (PERF.md)."""
    inv = sigma2 / r2
    s6 = inv * inv * inv
    fscale = 24.0 * epsilon / sigma2
    if not with_energy:
        fmag = jnp.where(valid, s6 * inv * (2.0 * fscale * s6 - fscale), 0.0)
        return fmag, None, None
    s12 = s6 * s6
    fmag = jnp.where(valid, (2.0 * s12 - s6) * inv * fscale, 0.0)
    e = jnp.where(valid, 4.0 * epsilon * (s12 - s6) - shift, 0.0)
    w = jnp.where(valid, (2.0 * s12 - s6) * (24.0 * epsilon), 0.0)
    return fmag, e, w


def lane_shift(v, offs, dims, coord_axis=None, box=0.0):
    """``out[..., l] = v[..., l + offs]`` over the flattened lane cells, with
    periodic wrap on each lane axis. If ``v`` is the coordinate along lane
    axis ``coord_axis``, wrapped cells get ``+-box`` so displacements stay
    minimal across the seam."""
    lead = v.shape[:-1]
    u = v.reshape(lead + tuple(dims))
    for k, (d, n) in enumerate(zip(offs, dims)):
        if d == 0:
            continue
        ax = len(lead) + k
        u = jnp.roll(u, -d, axis=ax)
        if coord_axis == k:
            idx = jax.lax.broadcasted_iota(jnp.int32, u.shape, ax)
            seam = idx == (n - 1 if d > 0 else 0)
            u = u + jnp.where(seam, d * box, 0.0).astype(u.dtype)
    return u.reshape(v.shape)


def half_shell(k: int):
    """Newton-halved lane offsets: ``(same_row, next_row)``. Same-row
    offsets are the lexicographically positive ones (each pair of a row
    once); next-row offsets are all ``3^k`` of them."""
    offs = list(itertools.product((-1, 0, 1), repeat=k))
    return [o for o in offs if o > (0,) * k], offs


def next_rows(v, delta: float = 0.0):
    """Row ``i+1`` of a full periodic grid, with ``+delta`` on the row that
    wraps (pass ``box`` for the x coordinate)."""
    nxt = jnp.roll(v, -1, axis=0)
    if delta:
        nxt = nxt.at[-1].add(delta)
    return nxt


def make_plain_raw(grid_fn: CellGridFn, sigma=1.0, epsilon=1.0, with_energy=False):
    """The plain Newton pair-block version of ``.raw`` (see module doc)."""
    dim = grid_fn.dim
    dims = lane_dims(grid_fn)
    box = float(grid_fn.box)
    cap = grid_fn.capacity
    prm = lj_params(grid_fn, sigma, epsilon)
    same_offs, next_offs = half_shell(dim - 1)

    def raw(*args, max_occ=None):
        del max_occ  # every slot is covered
        xs, xn = list(args[0::2]), list(args[1::2])

        def partner(src, o):
            return [
                lane_shift(v, o, dims, coord_axis=c - 1, box=box)
                for c, v in enumerate(src)
            ]

        def block(part, self_block=False):
            d = [s[:, :, None, :] - p[:, None, :, :] for s, p in zip(xs, part)]
            r2 = sum(dc * dc for dc in d)
            valid = (r2 < prm["cutoff2"]) & (r2 > 0.0)
            if self_block:
                a = jax.lax.broadcasted_iota(jnp.int32, (cap, cap), 0)
                b = jax.lax.broadcasted_iota(jnp.int32, (cap, cap), 1)
                valid = valid & (a < b)[None, :, :, None]
            fmag, e, w = lj_pair(r2, valid, with_energy=with_energy, **prm)
            terms = [fmag * dc for dc in d] + ([e, w] if with_energy else [])
            return [t.sum(axis=2) for t in terms], [t.sum(axis=1) for t in terms]

        # forces negate on the reaction side; energy and virial do not
        sign = [-1.0] * dim + [1.0, 1.0][: 2 * with_energy]
        ta, tb = block(xs, self_block=True)
        acc = [a + s * b for a, b, s in zip(ta, tb, sign)]
        for o in same_offs:
            ta, tb = block(partner(xs, o))
            neg = tuple(-d for d in o)
            acc = [
                x + a + s * lane_shift(b, neg, dims)
                for x, a, b, s in zip(acc, ta, tb, sign)
            ]
        racc = None
        for o in next_offs:
            ta, tb = block(partner(xn, o))
            neg = tuple(-d for d in o)
            acc = [x + a for x, a in zip(acc, ta)]
            r = [s * lane_shift(b, neg, dims) for b, s in zip(tb, sign)]
            racc = r if racc is None else [x + y for x, y in zip(racc, r)]
        out = acc[:dim] + racc[:dim]
        if with_energy:
            out += [acc[dim], racc[dim], acc[dim + 1], racc[dim + 1]]
        return tuple(out)

    return raw


def fold_reactions(out, dim: int, with_energy: bool):
    """Totals from a full-grid ``.raw`` output: reaction row ``i`` lands on
    row ``i+1`` (periodic)."""
    tot = [out[c] + jnp.roll(out[dim + c], 1, axis=0) for c in range(dim)]
    if with_energy:
        e, re, w, rw = out[2 * dim:]
        tot += [e + jnp.roll(re, 1, axis=0), w + jnp.roll(rw, 1, axis=0)]
    return tuple(tot)


def make_grid_force(
    grid_fn: CellGridFn,
    sigma: float = 1.0,
    epsilon: float = 1.0,
    with_energy: bool = False,
    n_rows: Optional[int] = None,
    impl: Optional[str] = None,
    interpret: bool = False,
):
    """Grid-level force function (see module doc). ``impl``: ``"plain"``,
    ``"triton"`` or None (:func:`choose_impl`). ``interpret=True`` runs the
    Triton kernel in the Pallas interpreter (tests only); without it the
    kernel needs a GPU and asking for it elsewhere raises. ``n_rows``: rows
    of ``.raw`` calls (default: the full grid)."""
    if impl is None:
        impl = choose_impl()
    if impl not in IMPLS:
        raise ValueError(f"unknown force impl {impl!r} (one of {IMPLS})")
    dim, box = grid_fn.dim, float(grid_fn.box)
    if impl == "triton":
        if not interpret and jax.default_backend() != "gpu":
            raise ValueError(
                "the Triton cell kernel needs a GPU; pass interpret=True to "
                "run it in the Pallas interpreter, or use impl='plain'"
            )
        from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_triton import (
            make_triton_force,
        )

        return make_triton_force(
            grid_fn, sigma=sigma, epsilon=epsilon, with_energy=with_energy,
            n_rows=n_rows, interpret=interpret,
        )

    raw = make_plain_raw(grid_fn, sigma, epsilon, with_energy)

    def grid_force(*coords, max_occ=None):
        args = []
        for c, v in enumerate(coords):
            args += [v, next_rows(v, box if c == 0 else 0.0)]
        return fold_reactions(raw(*args, max_occ=max_occ), dim, with_energy)

    grid_force.raw = raw
    grid_force.impl = impl
    return grid_force

"""Grid-resident LJ molecular dynamics (2D).

The engine keeps ALL particle state (positions, velocities, forces, particle
ids) permanently in the cell-grid layout ``(ncx, C, ncy)`` of the cell force
(cell_force.py), so the hot loop does no per-particle scatter or gather:

- the velocity-Verlet update is pure elementwise work on grids, run in
  *leapfrog form* inside windows (one kick per step instead of two
  half-kicks; half-kick in / half-unkick out at window boundaries) so each
  inner step is exactly one fused elementwise pass + one force call;
- forces come from the cell force reading the grids directly: no occupancy
  masks (empty slots hold the x sentinel ``SENTINEL_FACTOR*box``), no
  per-pair minimum-image rounds (periodic seams handled per block), no
  energy math in the hot loop (energy is computed on demand at sampling
  points);
- positions are NOT wrapped per step: between rebuilds a particle drifts at
  most skin/2 outside [0, box), which the seam-free pair math handles
  exactly; coordinates are wrapped once per rebuild;
- the skin monitor is a pair of displacement accumulators (``dispx/dispy``,
  reset at rebuild) plus a per-slot running max — one cheap fused
  elementwise op per step and a single reduction per window, replacing a
  per-step global max-reduce over min-imaged differences;
- cell re-binning (grid -> grid permutation) happens only when some particle
  has moved more than a skin fraction — every ~10-50 steps — and is the
  ONLY gather/scatter in the whole run;
- particle order is recovered on demand (sampling/export) via the carried
  particle-id grid.

Unit masses (the reference MD has no per-particle masses,
molecular_dynamics...:66-75). The physics is the reference's LJ 6-12 with
velocity Verlet (molecular_dynamics...:50-75) plus the cutoff structure it
lacks; parity vs the dense oracle is asserted in tests/test_grid_md.py.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_force import (
    make_grid_force,
)
from jax_tpus_benchmark_physics_simulation_tpu.utils import struct

# Empty grid slots store x = SENTINEL_FACTOR * box (y = 0). Together with the
# force's ``0 < r2 < cutoff^2`` validity test this excludes every pair that
# touches an empty slot without occupancy masks — see cell_force.py.
SENTINEL_FACTOR = 2.5


def named_scope(name: str):
    """Decorator: trace ``fn`` under ``jax.named_scope(name)``, so its ops
    carry the name in HLO metadata and profiler traces (the rebuild's share
    of a window is read from a trace by this name)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with jax.named_scope(name):
                return fn(*args, **kwargs)

        return wrapped

    return deco


def permute_rows_by_inverse(dest_flat, fields, fills, size: int, dtype):
    """Apply the slot permutation ``out[dest[i]] = row_i(fields)`` (holes ->
    ``fills``) as ONE single-column int scatter + ONE multi-column row
    gather, instead of a multi-column row scatter.

    The scatter target stays 4 bytes per row and the F columns move in one
    row gather. Semantics: ``inv[t] = i  iff  dest[i] = t`` (dest is
    injective on live rows), and unwritten targets keep ``size``, which
    gathers the fills row.
    """
    size_i = jnp.int32(size)
    inv = (
        jnp.full((size + 1,), size_i, jnp.int32)
        .at[dest_flat]
        .set(jnp.arange(size, dtype=jnp.int32), mode="drop", unique_indices=True)
    )[:size]
    vals = jnp.stack([v.reshape(-1) for v in fields], axis=-1)  # (size, F)
    vals_ext = jnp.concatenate(
        [vals, jnp.asarray(fills, dtype)[None, :]], axis=0
    )
    out = jnp.take(vals_ext, inv, axis=0)  # (size, F)
    # barrier: without it XLA may fuse this ONE row gather into the F
    # per-column consumers, replicating it as F element gathers
    return jax.lax.optimization_barrier(out)


@struct.dataclass
class GridMDState:
    """All (ncx, C, ncy_pad)-shaped leaves live permanently on device.

    ``fxg/fyg`` hold the TOTAL force (reaction-folded). ``dispx/dispy``
    accumulate per-slot displacement since the last rebuild (the Verlet-skin
    monitor; exact mirrors of the applied position increments, so no
    minimum-image arithmetic is ever needed on them).
    """

    xg: jax.Array
    yg: jax.Array
    vxg: jax.Array
    vyg: jax.Array
    fxg: jax.Array
    fyg: jax.Array
    occ: jax.Array  # float 1.0/0.0
    pid: jax.Array  # int32 particle id, sentinel -1
    dispx: jax.Array  # displacement since last rebuild
    dispy: jax.Array
    dmax2: jax.Array  # scalar: running max of dispx^2+dispy^2 since rebuild
    overflow: jax.Array  # bool
    time: jax.Array
    # Kahan compensation residuals (compensated=True): kill the f32 random
    # walk of tiny per-step increments into large coordinates/velocities.
    crx: Optional[jax.Array] = None
    cry: Optional[jax.Array] = None
    cvx: Optional[jax.Array] = None
    cvy: Optional[jax.Array] = None
    # PRNG key for stochastic (Langevin) windows; None for NVE. Not a
    # per-slot field — rebuilds carry it through untouched.
    rng: Optional[jax.Array] = None


class GridMD:
    """Factory for the grid-resident MD step functions. All members are
    static Python; the state is the GridMDState pytree."""

    def __init__(
        self,
        grid_fn: CellGridFn,
        sigma: float = 1.0,
        epsilon: float = 1.0,
        dt: float = 1e-3,
        compensated: bool = False,
    ):
        assert grid_fn.dim == 2, "grid-resident MD is 2D (grid_md3 covers 3D)"
        self.compensated = compensated
        self.grid_fn = grid_fn
        self.cps = grid_fn.cells_per_side
        self.cap = grid_fn.capacity
        self.box = grid_fn.box
        self.skin = grid_fn.skin
        self.n = grid_fn.n
        self.dt = dt
        self.sentinel = SENTINEL_FACTOR * float(grid_fn.box)
        self.grid_shape = (self.cps, self.cap, self.cps)
        self.size = self.cps * self.cap * self.cps
        # the platform picks the implementation (cell_force.choose_impl)
        self._force_kw = dict(sigma=sigma, epsilon=epsilon)
        # hot-path force: forces only; energy force: built the same way,
        # called only at sampling points (potential_energy).
        self.force_kernel = make_grid_force(grid_fn, **self._force_kw)
        self.energy_kernel = make_grid_force(
            grid_fn, with_energy=True, **self._force_kw
        )

    # -- layout helpers ------------------------------------------------------
    def _slot2(self, position: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Flat grid slot for each particle + overflow flag."""
        cps, cap = self.cps, self.cap
        coords = jnp.clip(
            (position // (self.box / cps)).astype(jnp.int32), 0, cps - 1
        )
        ids = coords[:, 0] * cps + coords[:, 1]
        order = jnp.argsort(ids)
        sorted_ids = ids[order]
        seg = jnp.searchsorted(sorted_ids, sorted_ids, side="left")
        rank = jnp.arange(ids.shape[0], dtype=jnp.int32) - seg.astype(jnp.int32)
        overflow = jnp.any(rank >= cap)
        rank = jnp.minimum(rank, cap - 1)
        slot_sorted = sorted_ids * cap + rank  # (cell, a) flat
        slot = jnp.zeros_like(ids).at[order].set(slot_sorted)
        # map (cell_id, a) -> (cx, a, cy) grid flat index
        cell_id = slot // cap
        aa = slot % cap
        return ((cell_id // cps) * cap + aa) * cps + cell_id % cps, overflow

    def prepare(self, state: GridMDState) -> GridMDState:
        """Placement hook (ShardedGridMD shards here; base is identity)."""
        return state

    def init(
        self, position: jax.Array, velocity: jax.Array, seed: Optional[int] = None
    ) -> GridMDState:
        """``seed`` arms the state's PRNG stream (required by Langevin
        windows, ignored by NVE ones)."""
        slot2, overflow = self._slot2(position)
        dtype = position.dtype

        def put(v, fill=0.0):
            z = jnp.full((self.size,), fill, dtype)
            return z.at[slot2].set(v).reshape(self.grid_shape)

        xg = put(position[:, 0], fill=self.sentinel)
        yg = put(position[:, 1])
        vxg, vyg = put(velocity[:, 0]), put(velocity[:, 1])
        occ = put(jnp.ones((self.n,), dtype))
        pid = (
            jnp.full((self.size,), -1, jnp.int32)
            .at[slot2]
            .set(jnp.arange(self.n, dtype=jnp.int32))
            .reshape(self.grid_shape)
        )
        fxg, fyg = self.force_kernel(xg, yg)
        zg = jnp.zeros(self.grid_shape, dtype)
        comp = dict(crx=zg, cry=zg, cvx=zg, cvy=zg) if self.compensated else {}
        rng = {} if seed is None else dict(rng=jax.random.PRNGKey(seed))
        return GridMDState(
            xg=xg, yg=yg, vxg=vxg, vyg=vyg, fxg=fxg, fyg=fyg,
            occ=occ, pid=pid, dispx=zg, dispy=zg,
            dmax2=jnp.zeros((), dtype),
            overflow=overflow, time=jnp.zeros((), dtype),
            **comp, **rng,
        )

    # -- migration rebuild (sort-free) ----------------------------------------
    def _migration_dest(self, s: GridMDState):
        """Allocation phase of the migration rebuild. Returns wrapped
        coordinates, the per-slot flat destination index (``self.size`` =
        dropped) and the overflow flag."""
        cps, cap, box = self.cps, self.cap, self.box
        gs = self.grid_shape
        occ_b = s.occ > 0.5

        # wrap coordinates periodically (unwrapped drift < skin/2 since the
        # last rebuild); sentinel slots produce garbage here but are gated by
        # occ_b everywhere below and re-filled by the permutation.
        xw = jnp.mod(s.xg, box)
        yw = jnp.mod(s.yg, box)

        # current cell coords of each slot
        cx = jax.lax.broadcasted_iota(jnp.int32, gs, 0)
        cy = jax.lax.broadcasted_iota(jnp.int32, gs, 2)
        # target cell coords from positions
        cell = box / cps
        txc = jnp.clip((xw // cell).astype(jnp.int32), 0, cps - 1)
        tyc = jnp.clip((yw // cell).astype(jnp.int32), 0, cps - 1)
        # migration direction in {-1, 0, 1} with periodic wrap
        dxc = (txc - cx + 1 + cps) % cps - 1
        dyc = (tyc - cy + 1 + cps) % cps - 1
        moved_far = occ_b & ((jnp.abs(dxc) > 1) | (jnp.abs(dyc) > 1))
        overflow = s.overflow | jnp.any(moved_far)
        # clamp far-movers to "stay" (flagged above), and re-derive the
        # target coords from the CLAMPED directions so dest stays consistent
        # with the slot allocation even in flagged states (a far-mover is
        # allocated a stayer slot in its SOURCE cell; writing it to the
        # unclamped target cell could collide with that cell's own slots)
        dxc = jnp.where(moved_far, 0, dxc)
        dyc = jnp.where(moved_far, 0, dyc)
        txc = (cx + dxc) % cps
        tyc = (cy + dyc) % cps

        def roll_cells(v, dx, dy):
            """Periodic shift by (dx, dy) CELLS:
            out[X, :, Y] = v[(X - dx) % cps, :, (Y - dy) % cps]."""
            return jnp.roll(v, (dx, dy), axis=(0, 2))

        dirs = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]
        # Allocation: per target cell, classes land in fixed order (stayers
        # and each direction), each class's slots starting after the counts
        # of all earlier classes. A target receives movers of direction d
        # from exactly one source cell (t - d), so a mover's in-class rank at
        # the target equals its rank within its source cell's class.
        # Batched over all 9 classes at once: one one-hot stack + one cumsum
        # gives every class's in-cell ranks, and the class-order base
        # accumulation is an exclusive cumsum over the tiny per-class count
        # arrays.
        dcode = (dxc + 1) * 3 + (dyc + 1)  # class in 0..8
        dm = (
            jax.lax.broadcasted_iota(jnp.int32, (9,) + gs, 0) == dcode[None]
        ) & occ_b[None]
        dmi = dm.astype(jnp.int32)
        inc = jnp.cumsum(dmi, axis=2)  # slot axis
        ranks = inc - dmi
        counts = jax.lax.slice_in_dim(inc, cap - 1, cap, axis=2)
        rc = jnp.stack(
            [roll_cells(counts[j], dx, dy) for j, (dx, dy) in enumerate(dirs)]
        )
        bases_t = jnp.cumsum(rc, axis=0) - rc
        base_src = jnp.stack(
            [roll_cells(bases_t[j], -dx, -dy) for j, (dx, dy) in enumerate(dirs)]
        )
        target_a = jnp.where(
            occ_b, jnp.sum(jnp.where(dm, base_src + ranks, 0), axis=0), -1
        )

        slot_overflow = jnp.any((target_a >= cap) & occ_b)
        overflow = overflow | slot_overflow
        valid = occ_b & (target_a >= 0) & (target_a < cap)

        # flat destination index (in target frame); OOB -> dropped
        dest = ((txc * cap + target_a) * cps + tyc).astype(jnp.int32)
        dest = jnp.where(valid, dest, self.size)
        return xw, yw, dest.reshape(-1), overflow

    @named_scope("rebuild")
    def _rebuild_migrate(self, s: GridMDState) -> GridMDState:
        """Sort-free re-binning exploiting temporal coherence: between
        rebuilds every particle moves < skin/2 < cell size, so its new cell
        is one of the 9 neighbors of its assigned cell. Slot allocation per
        target cell is computed with rolls + small-axis cumsums (no global
        argsort, see :meth:`_migration_dest`); the slot permutation is an
        inverse-index scatter + one (size, F) row gather
        (permute_rows_by_inverse). Pure jnp, so GSPMD partitions it on the
        sharded state of ShardedGridMD as well. A particle that somehow
        moved further than one cell raises ``overflow`` (and is kept in
        place — loud, not silent). Coordinates are wrapped back into
        [0, box) here (the only place they ever are) and empty slots
        re-filled with the sentinel."""
        gs = self.grid_shape
        xw, yw, dest_flat, overflow = self._migration_dest(s)

        assert self.n < (1 << 24), "pid-in-f32 packing requires n < 2^24"
        dtype = s.xg.dtype
        fields = [xw, yw, s.vxg, s.vyg, s.fxg, s.fyg, s.occ,
                  s.pid.astype(dtype)]
        fills = [self.sentinel, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0]
        if s.crx is not None:
            fields += [s.crx, s.cry, s.cvx, s.cvy]
            fills += [0.0, 0.0, 0.0, 0.0]
        out = permute_rows_by_inverse(dest_flat, fields, fills, self.size, dtype)

        def take(k):
            return out[:, k].reshape(gs)

        zg = jnp.zeros(gs, dtype)
        comp = (
            dict(crx=take(8), cry=take(9), cvx=take(10), cvy=take(11))
            if s.crx is not None
            else {}
        )
        return s.replace(
            xg=take(0),
            yg=take(1),
            vxg=take(2),
            vyg=take(3),
            fxg=take(4),
            fyg=take(5),
            occ=take(6),
            pid=take(7).astype(jnp.int32),
            dispx=zg,
            dispy=zg,
            dmax2=jnp.zeros((), dtype),
            overflow=overflow,
            **comp,
        )

    # -- rebuild (grid -> grid permutation, sort-based oracle) ---------------
    def _rebuild(self, s: GridMDState) -> GridMDState:
        cps, cap = self.cps, self.cap
        occ = s.occ.reshape(-1)
        x = jnp.mod(s.xg, self.box).reshape(-1)
        y = jnp.mod(s.yg, self.box).reshape(-1)
        n_cells = cps * cps

        cxi = jnp.clip((x // (self.box / cps)).astype(jnp.int32), 0, cps - 1)
        cyi = jnp.clip((y // (self.box / cps)).astype(jnp.int32), 0, cps - 1)
        ids = jnp.where(occ > 0.5, cxi * cps + cyi, n_cells)  # empties last

        order = jnp.argsort(ids)
        sorted_ids = ids[order]
        seg = jnp.searchsorted(sorted_ids, sorted_ids, side="left")
        rank = jnp.arange(self.size, dtype=jnp.int32) - seg.astype(jnp.int32)
        real = sorted_ids < n_cells
        overflow = s.overflow | jnp.any(real & (rank >= cap))
        rank = jnp.minimum(rank, cap - 1)
        cx = sorted_ids // cps
        cy = sorted_ids % cps
        new_slot = (cx * cap + rank) * cps + cy
        new_slot = jnp.where(real, new_slot, self.size)  # drop empties

        def scat(v, fill=0.0, dtype=None):
            vv = v.reshape(-1)[order]
            out = jnp.full((self.size,), fill, dtype or v.dtype)
            return out.at[new_slot].set(vv, mode="drop").reshape(self.grid_shape)

        zg = jnp.zeros(self.grid_shape, s.xg.dtype)
        comp = (
            dict(crx=scat(s.crx), cry=scat(s.cry), cvx=scat(s.cvx), cvy=scat(s.cvy))
            if s.crx is not None
            else {}
        )
        return s.replace(
            xg=scat(x.reshape(self.grid_shape), fill=self.sentinel),
            yg=scat(y.reshape(self.grid_shape)),
            vxg=scat(s.vxg),
            vyg=scat(s.vyg),
            fxg=scat(s.fxg),
            fyg=scat(s.fyg),
            occ=scat(s.occ),
            pid=scat(s.pid, fill=-1, dtype=jnp.int32),
            dispx=zg,
            dispy=zg,
            dmax2=jnp.zeros((), s.xg.dtype),
            overflow=overflow,
            **comp,
        )

    def _needs_rebuild(self, s: GridMDState, frac: float = 0.5) -> jax.Array:
        """Gate on the scalar displacement max maintained by the windows
        (no grid-wide reduce here). ``dmax2`` is the running max within the
        last window started from the then-current displacement — slightly
        conservative versus an exact current-displacement check, never
        unsafe (peaks were checked against the violation threshold when they
        happened)."""
        return ~(s.dmax2 <= (frac * self.skin) ** 2)

    # -- MD step ---------------------------------------------------------------
    @staticmethod
    def _kadd(x, c, inc):
        """Kahan-compensated x += inc with residual c."""
        y = inc - c
        t = x + y
        c = (t - x) - y
        return t, c

    def _make_window(
        self, force_fn, n_inner: int, reduce_max=None, thermostat=None, rng_fold=None
    ):
        """Leapfrog window: ``window(s) -> s`` advancing ``n_inner``
        velocity-Verlet steps with ONE force call and ONE fused elementwise
        pass per step (kick+drift merged; half-kick in / half-unkick out at
        the window boundary — algebraically identical to per-step
        kick-drift-kick). The per-slot running max of the displacement
        accumulators implements the skin-violation monitor: if any particle
        exceeded skin/2 mid-window (a pair could have entered the cutoff
        unseen) the state's ``overflow`` flag is raised — loud post-hoc
        detection, same contract as capacity overflow. (The reference has no
        such guard at all.)

        ``force_fn(x, y) -> (fx, fy)`` returns reaction-folded totals;
        ``reduce_max`` post-processes the scalar displacement max (the
        sharded engine passes a pmax).

        ``thermostat=(gamma, kT)`` makes each step a BAOAB Langevin step
        (NVT): the exact Ornstein-Uhlenbeck map ``vh <- c1*vh + c2*xi`` sits
        between two half-drifts, with ``c1 = exp(-gamma*dt)`` and
        ``c2 = sqrt(kT*(1-c1^2))`` (unit mass). Both drifts use velocities
        the force never sees mid-step, so the single force call per step is
        preserved. Noise is occupancy-masked — sentinel slots stay exactly
        at rest. Requires ``s.rng`` (see :meth:`init` ``seed``); velocity
        Kahan compensation is bypassed under a thermostat (the OU map
        rescales vh, which would desynchronize the residuals — and a
        thermostatted run has no conserved energy to protect).

        ``rng_fold``: per-call key post-fold — the sharded engines pass
        ``fold_in(k, axis_index)`` so each shard draws a decorrelated noise
        stream from the replicated state key. Noise shape follows the
        (possibly shard-local) array shape, not the global grid."""
        dt = self.dt
        comp = bool(self.compensated)
        pos_only = self.compensated == "positions"
        kadd = self._kadd
        if reduce_max is None:
            reduce_max = lambda v: v
        if rng_fold is None:
            rng_fold = lambda k: k
        if thermostat is not None:
            gamma, kt_target = thermostat
            c1 = float(np.exp(-gamma * dt))
            c2 = float(np.sqrt(kt_target * (1.0 - c1 * c1)))

        def window(s: GridMDState) -> GridMDState:
            if thermostat is not None and s.rng is None:
                raise ValueError(
                    "Langevin window needs a PRNG stream: init(..., seed=...)"
                )
            vhx = s.vxg + 0.5 * dt * s.fxg
            vhy = s.vyg + 0.5 * dt * s.fyg
            dm0 = s.dispx * s.dispx + s.dispy * s.dispy
            carry = (
                s.xg, s.yg, s.crx, s.cry, vhx, vhy, s.cvx, s.cvy,
                s.dispx, s.dispy, dm0, s.fxg, s.fyg,
            )

            def body(i, c):
                x, y, crx, cry, vhx, vhy, cvx, cvy, dpx, dpy, dm, fx, fy = c
                if thermostat is None:
                    incx = dt * vhx
                    incy = dt * vhy
                else:
                    # A O A: drift half on vh, OU-refresh vh, drift half on
                    # the refreshed vh; the increments fuse into one add.
                    k = rng_fold(jax.random.fold_in(s.rng, i))
                    xi = jax.random.normal(k, (2,) + x.shape, x.dtype)
                    vpx = c1 * vhx + c2 * (xi[0] * s.occ)
                    vpy = c1 * vhy + c2 * (xi[1] * s.occ)
                    incx = 0.5 * dt * (vhx + vpx)
                    incy = 0.5 * dt * (vhy + vpy)
                    vhx, vhy = vpx, vpy
                if comp:
                    x, crx = kadd(x, crx, incx)
                    y, cry = kadd(y, cry, incy)
                else:
                    x = x + incx
                    y = y + incy
                dpx = dpx + incx
                dpy = dpy + incy
                dm = jnp.maximum(dm, dpx * dpx + dpy * dpy)
                fx, fy = force_fn(x, y)
                if comp and not pos_only and thermostat is None:
                    vhx, cvx = kadd(vhx, cvx, dt * fx)
                    vhy, cvy = kadd(vhy, cvy, dt * fy)
                else:
                    vhx = vhx + dt * fx
                    vhy = vhy + dt * fy
                return (x, y, crx, cry, vhx, vhy, cvx, cvy, dpx, dpy, dm, fx, fy)

            c = jax.lax.fori_loop(0, n_inner, body, carry)
            x, y, crx, cry, vhx, vhy, cvx, cvy, dpx, dpy, dm, fx, fy = c
            dmax2 = reduce_max(jnp.max(dm))
            # NaN-safe: a NaN displacement (diverged physics, e.g. the
            # reference's overlapping uniform init) must TRIP the flag,
            # not slip past it (NaN > t is False; ~(NaN <= t) is True)
            violation = ~(dmax2 <= (0.5 * self.skin) ** 2)
            rng = (
                {}
                if thermostat is None
                else dict(rng=jax.random.fold_in(s.rng, n_inner))
            )
            return s.replace(
                xg=x, yg=y,
                vxg=vhx - 0.5 * dt * fx,
                vyg=vhy - 0.5 * dt * fy,
                fxg=fx, fyg=fy,
                crx=crx, cry=cry, cvx=cvx, cvy=cvy,
                dispx=dpx, dispy=dpy,
                dmax2=dmax2,
                overflow=s.overflow | violation,
                time=s.time + n_inner * dt,
                **rng,
            )

        return window

    def step_nocheck(self, s: GridMDState) -> GridMDState:
        """One velocity-Verlet step with NO rebuild logic (single-step window).
        Only valid inside rebuild-gated windows; prefer
        :meth:`make_chunk_step` for long runs."""
        return self._window_builder(1)(s)

    def step(self, s: GridMDState) -> GridMDState:
        """Single step with a per-step displacement-gated rebuild. Correct for
        any dt, but pays the gate and branch every step — prefer
        :meth:`make_chunk_step` for long runs."""
        s = jax.lax.cond(self._needs_rebuild(s), self._rebuild_migrate, lambda t: t, s)
        return self.step_nocheck(s)

    def _window_builder(self, n_inner: int, thermostat=None):
        """Integrator-window factory hook: every driver below builds its
        windows through this, so the sharded subclass overrides ONE method
        (halo force + shard_map wrapper) and inherits chunk AND cond-free
        production drivers unchanged."""
        return self._make_window(self.force_kernel, n_inner, thermostat=thermostat)

    def make_chunk_step(self, n_inner: int, gate_frac: float = 0.25, thermostat=None):
        """Returns ``chunk(s) -> s`` advancing ``n_inner`` steps with a single
        (conditional) rebuild up front and a branch-free leapfrog window.
        ``gate_frac``: rebuild when displacement-since-rebuild exceeds this
        fraction of the skin; the window that follows must fit inside the
        remaining ``(1/2 - gate_frac)`` margin before a true (flagged)
        violation at skin/2 — size ``n_inner`` with
        :meth:`auto_inner_steps` using the SAME ``gate_frac``. Higher gates
        buy fewer rebuilds at the price of shorter windows.
        ``thermostat=(gamma, kT)`` makes the windows BAOAB Langevin (NVT) —
        see :meth:`_make_window`."""
        window = self._window_builder(n_inner, thermostat=thermostat)

        def chunk(s: GridMDState) -> GridMDState:
            s = jax.lax.cond(
                self._needs_rebuild(s, frac=gate_frac),
                self._rebuild_migrate,
                lambda t: t,
                s,
            )
            return window(s)

        return chunk

    def make_production_run(
        self, n_steps: int, n_inner: int, gate_frac: float = 0.25, thermostat=None
    ):
        """Cond-free production driver: ``run(s) -> s`` advancing EXACTLY
        ``n_steps`` (``n_inner`` must divide it) as a nested while-loop —
        inner loop runs k-step windows until the rebuild gate trips (checked
        between windows, the same cadence as :meth:`make_chunk_step`'s
        cond), outer loop rebuilds UNCONDITIONALLY and re-enters. A
        data-dependent ``lax.cond`` can copy the state through its branch;
        while-loop carries alias in place, so this form has no branch to
        copy through. Trajectory-equivalent to the chunk driver (same
        windows, same gate cadence, same rebuilds — the only extra is one
        trailing rebuild per call, amortized over ``n_steps``).
        ``n_inner``/``gate_frac`` contract is :meth:`auto_chunk_params`'s."""
        assert n_steps % n_inner == 0, (n_steps, n_inner)
        window = self._window_builder(n_inner, thermostat=thermostat)

        def run(s: GridMDState) -> GridMDState:
            def inner_cond(c):
                t, done = c
                return (done < n_steps) & ~self._needs_rebuild(t, frac=gate_frac)

            def inner_body(c):
                t, done = c
                return window(t), done + n_inner

            def outer_body(c):
                c = jax.lax.while_loop(inner_cond, inner_body, c)
                t, done = c
                return self._rebuild_migrate(t), done

            def outer_cond(c):
                return c[1] < n_steps

            s, _ = jax.lax.while_loop(
                outer_cond, outer_body, (s, jnp.zeros((), jnp.int32))
            )
            return s

        return run

    def make_production_run_fixed(self, n_steps: int, cadence: int, thermostat=None):
        """Fixed-cadence production driver, 2D port of
        grid_md3.GridMD3.make_production_run_fixed: a single fori_loop of ``rebuild ->
        cadence-step window`` blocks — zero gate evaluation and zero
        dynamic-while machinery. NVE-only; safety demotes to the window's
        skin/2 violation flag (loud, never silent). Use :meth:`auto_cadence`
        on the MEASURED equilibrated kT and only on equilibrated states.
        ``n_steps % cadence`` trailing steps run as one remainder block."""
        assert cadence >= 1, cadence
        assert thermostat is None, (
            "fixed-cadence driver is NVE-only; Langevin runs use the gated "
            "drivers where the per-window RNG fold is already paid"
        )
        window = self._window_builder(cadence)
        nb, rem = divmod(n_steps, cadence)
        if rem:
            tail = self._window_builder(rem)

        def run(s: GridMDState) -> GridMDState:
            def body(i, t):
                return window(self._rebuild_migrate(t))

            s = jax.lax.fori_loop(0, nb, body, s)
            if rem:
                s = tail(self._rebuild_migrate(s))
            return s

        return run

    def auto_cadence(self, kt: float = 1.0, n_steps: int = 100_000) -> int:
        """Rebuild cadence for :meth:`make_production_run_fixed` — Gaussian
        extreme-value sizing over the whole run; see
        grid_md3.GridMD3.auto_cadence for the derivation. (The fixed driver
        is not used by lj_fluid in 2D, which runs the gated driver.)"""
        import math

        samples = max(float(self.n) * max(n_steps, 1), math.e)
        vmax = math.sqrt(2.0 * math.log(samples)) * kt**0.5
        return max(1, int(0.93 * 0.5 * self.skin / (vmax * self.dt)))

    def auto_chunk_params(self, kt: float = 1.0) -> Tuple[int, float]:
        """``(n_inner, gate_frac)`` sized TOGETHER: the highest rebuild gate
        whose remaining window budget still fits >= 1 step at the 8-sigma
        tail speed, capped at a preferred gate (0.40 at N >= 50k, 0.35
        below). The preferences were fitted to an earlier build's kernel
        and rebuild costs and have not been re-fitted on a GPU; any gate
        here is safe, because the skin/2 margin sizes the window. Falls
        back toward 0.25 for large dt where the margin cannot fit one
        step. Pass BOTH values to
        :meth:`make_chunk_step` — mixing a high gate with a window sized
        for a lower one would erode the violation margin."""
        prefer = 0.40 if self.n >= 50_000 else 0.35
        for gate in (0.45, 0.4, 0.35, 0.3, 0.25):
            if gate > prefer:
                continue
            k = int(((0.5 - gate) * self.skin) / (8.0 * kt**0.5 * self.dt))
            if k >= 1:
                return k, gate
        return 1, 0.25

    def auto_inner_steps(
        self, kt: float = 1.0, vmax_sigmas: float = 8.0, gate_frac: float = 0.25
    ) -> int:
        """Rebuild cadence sized for the Maxwell tail.

        A chunk rebuilds when displacement-since-rebuild exceeds
        ``gate_frac * skin`` and flags a violation at ``skin/2``; the window
        must therefore satisfy ``v_tail * dt * k < (1/2 - gate_frac) * skin``
        for the fastest particle we care about. With 1e5 particles over 1e6
        steps the relevant tail is ~8 sigma (P(v > 8 sqrt(kT)) ~ 1e-14 per
        particle-window) — the earlier 4-sigma sizing produced real
        violations at N=100k (speeds > 5.7 occur constantly at that scale).
        """
        vmax = vmax_sigmas * kt**0.5
        k = int(((0.5 - gate_frac) * self.skin) / (vmax * self.dt))
        return max(1, k)

    # -- observables / export ---------------------------------------------------
    def kinetic_energy(self, s: GridMDState) -> jax.Array:
        return 0.5 * jnp.sum((s.vxg**2 + s.vyg**2) * s.occ)

    def potential_energy(self, s: GridMDState) -> jax.Array:
        """Computed on demand (one energy-kernel pass) — the hot loop never
        does energy math. Each pair's (shifted) LJ energy is counted on both
        partners, hence the 0.5."""
        _, _, e, _ = self.energy_kernel(s.xg, s.yg)
        return 0.5 * jnp.sum(e)

    def virial(self, s: GridMDState) -> jax.Array:
        """Pair virial ``W = sum_pairs r . f = sum_pairs 24*eps*(2(s/r)^12 -
        (s/r)^6)``, from the same sampling-only kernel pass as the energy
        (each pair counted on both partners, hence the 0.5). Feeds
        :meth:`pressure`; the reference computes no pressure at all."""
        _, _, _, w = self.energy_kernel(s.xg, s.yg)
        return 0.5 * jnp.sum(w)

    def pressure(self, s: GridMDState) -> jax.Array:
        """Instantaneous virial pressure ``P = (2*KE + W) / (d * V)``
        (d = 2, V = box^2). Average over production samples for the
        thermodynamic value."""
        return (2.0 * self.kinetic_energy(s) + self.virial(s)) / (
            2.0 * self.box**2
        )

    def positions(self, s: GridMDState) -> jax.Array:
        """(N, 2) positions in particle order, wrapped into [0, box) (one
        gather — use at sampling stride, not per step)."""
        pid = s.pid.reshape(-1)
        tgt = jnp.where(pid >= 0, pid, self.n)
        out = jnp.zeros((self.n + 1, 2), s.xg.dtype)
        out = out.at[tgt, 0].set(s.xg.reshape(-1), mode="drop")
        out = out.at[tgt, 1].set(s.yg.reshape(-1), mode="drop")
        return jnp.mod(out[: self.n], self.box)

    def velocities(self, s: GridMDState) -> jax.Array:
        pid = s.pid.reshape(-1)
        tgt = jnp.where(pid >= 0, pid, self.n)
        out = jnp.zeros((self.n + 1, 2), s.vxg.dtype)
        out = out.at[tgt, 0].set(s.vxg.reshape(-1), mode="drop")
        out = out.at[tgt, 1].set(s.vyg.reshape(-1), mode="drop")
        return out[: self.n]

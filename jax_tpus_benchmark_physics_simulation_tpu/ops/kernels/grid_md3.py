"""Grid-resident LJ molecular dynamics (3D) — generalization of the 2D
engine (grid_md.py; read that docstring first — every design choice there
carries over).

State lives permanently in the (ncx, C, L) cell-grid layout of the cell
force (cell_force.py), with the (y, z) cell plane flattened into the lane
axis (lane = cy*ncz + cz, L = ncy*ncz). The step is the same leapfrog-window
scheme: one fused elementwise pass + one force call per step, displacement
accumulators for the skin monitor, Kahan compensation optional,
migration-based re-binning (rolls + small-axis cumsums over the 27 3D
directions — no argsort) as the only gather/scatter in the run.
Coordinates are wrapped only at rebuilds.

The reference MD is dim=2-hardcoded (molecular_dynamics_jax_single-host_
workload.py:26); 3D at the 100k-particle scale is beyond-reference scope.
Physics parity vs the dense oracle is asserted in tests/test_grid_md3.py.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_force import (
    make_grid_force,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import (
    SENTINEL_FACTOR,
    named_scope,
    permute_rows_by_inverse,
)
from jax_tpus_benchmark_physics_simulation_tpu.utils import struct


@struct.dataclass
class GridMD3State:
    """All (ncx, C, P)-shaped leaves live permanently on device (see
    grid_md.GridMDState — same contract, third coordinate added)."""

    xg: jax.Array
    yg: jax.Array
    zg: jax.Array
    vxg: jax.Array
    vyg: jax.Array
    vzg: jax.Array
    fxg: jax.Array
    fyg: jax.Array
    fzg: jax.Array
    occ: jax.Array  # float 1.0/0.0
    pid: jax.Array  # int32 particle id, sentinel -1
    dispx: jax.Array  # displacement since last rebuild
    dispy: jax.Array
    dispz: jax.Array
    dmax2: jax.Array  # scalar running max of |disp|^2 since rebuild
    overflow: jax.Array  # bool
    time: jax.Array
    # global max cell occupancy at the last (re)binning — the dynamic
    # partner-slot bound of the force kernel (occupied slots are compacted
    # to the low indices of each cell, so slots past it are pure sentinel
    # work and are skipped). None -> full capacity.
    max_occ: Optional[jax.Array] = None
    # Kahan compensation residuals (compensated=True/"positions")
    crx: Optional[jax.Array] = None
    cry: Optional[jax.Array] = None
    crz: Optional[jax.Array] = None
    cvx: Optional[jax.Array] = None
    cvy: Optional[jax.Array] = None
    cvz: Optional[jax.Array] = None
    # PRNG key for stochastic (Langevin) windows; None for NVE. Not a
    # per-slot field — rebuilds carry it through untouched.
    rng: Optional[jax.Array] = None


class GridMD3:
    """Factory for the 3D grid-resident MD step functions."""

    def __init__(
        self,
        grid_fn: CellGridFn,
        sigma: float = 1.0,
        epsilon: float = 1.0,
        dt: float = 1e-3,
        compensated: bool = False,
    ):
        assert grid_fn.dim == 3, "GridMD3 is 3D (grid_md.GridMD covers 2D)"
        self.compensated = compensated
        self.grid_fn = grid_fn
        self.cps = grid_fn.cells_per_side
        self.cap = grid_fn.capacity
        self.lanes = self.cps * self.cps
        self.box = grid_fn.box
        self.skin = grid_fn.skin
        self.n = grid_fn.n
        self.dt = dt
        self.sentinel = SENTINEL_FACTOR * float(grid_fn.box)
        self.grid_shape = (self.cps, self.cap, self.lanes)
        self.size = self.cps * self.cap * self.lanes
        # the platform picks the implementation (cell_force.choose_impl)
        self._force_kw = dict(sigma=sigma, epsilon=epsilon)
        self.force_kernel = make_grid_force(grid_fn, **self._force_kw)
        self.energy_kernel = make_grid_force(
            grid_fn, with_energy=True, **self._force_kw
        )

    # -- layout helpers ------------------------------------------------------
    def _slot3(self, position: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Flat grid slot for each particle + overflow flag."""
        cps, cap = self.cps, self.cap
        coords = jnp.clip(
            (position // (self.box / cps)).astype(jnp.int32), 0, cps - 1
        )
        ids = (coords[:, 0] * cps + coords[:, 1]) * cps + coords[:, 2]
        order = jnp.argsort(ids)
        sorted_ids = ids[order]
        seg = jnp.searchsorted(sorted_ids, sorted_ids, side="left")
        rank = jnp.arange(ids.shape[0], dtype=jnp.int32) - seg.astype(jnp.int32)
        overflow = jnp.any(rank >= cap)
        rank = jnp.minimum(rank, cap - 1)
        slot_sorted = sorted_ids * cap + rank  # (cell, a) flat
        slot = jnp.zeros_like(ids).at[order].set(slot_sorted)
        cell_id = slot // cap
        aa = slot % cap
        cx = cell_id // (cps * cps)
        lane = cell_id % (cps * cps)  # cy*ncz + cz, the packed lane index
        return (cx * cap + aa) * self.lanes + lane, overflow

    def prepare(self, state: GridMD3State) -> GridMD3State:
        """Placement hook (parity with GridMD.prepare)."""
        return state

    @staticmethod
    def _max_occ(occ: jax.Array) -> jax.Array:
        """Global max cell occupancy (slot axis is 1)."""
        return jnp.max(jnp.sum(occ, axis=1)).astype(jnp.int32)

    def init(
        self, position: jax.Array, velocity: jax.Array, seed: Optional[int] = None
    ) -> GridMD3State:
        """``seed`` arms the state's PRNG stream (required by Langevin
        windows, ignored by NVE ones)."""
        slot, overflow = self._slot3(position)
        dtype = position.dtype

        def put(v, fill=0.0):
            z = jnp.full((self.size,), fill, dtype)
            return z.at[slot].set(v).reshape(self.grid_shape)

        xg = put(position[:, 0], fill=self.sentinel)
        yg = put(position[:, 1])
        zg = put(position[:, 2])
        vxg, vyg, vzg = (put(velocity[:, k]) for k in range(3))
        occ = put(jnp.ones((self.n,), dtype))
        pid = (
            jnp.full((self.size,), -1, jnp.int32)
            .at[slot]
            .set(jnp.arange(self.n, dtype=jnp.int32))
            .reshape(self.grid_shape)
        )
        max_occ = self._max_occ(occ)
        fxg, fyg, fzg = self.force_kernel(xg, yg, zg, max_occ=max_occ)
        zeros = jnp.zeros(self.grid_shape, dtype)
        comp = (
            dict(crx=zeros, cry=zeros, crz=zeros, cvx=zeros, cvy=zeros, cvz=zeros)
            if self.compensated
            else {}
        )
        rng = {} if seed is None else dict(rng=jax.random.PRNGKey(seed))
        return GridMD3State(
            xg=xg, yg=yg, zg=zg, vxg=vxg, vyg=vyg, vzg=vzg,
            fxg=fxg, fyg=fyg, fzg=fzg,
            occ=occ, pid=pid, dispx=zeros, dispy=zeros, dispz=zeros,
            dmax2=jnp.zeros((), dtype),
            overflow=overflow, time=jnp.zeros((), dtype),
            max_occ=max_occ,
            **comp, **rng,
        )

    # -- migration rebuild (sort-free) ----------------------------------------
    def _migration_dest3(self, s: GridMD3State):
        """Allocation phase of the 3D migration rebuild. Returns wrapped
        coordinates, the per-slot flat destination index (``self.size`` =
        dropped) and the overflow flag. The (y, z) cell rolls are rolls of
        the lane axis viewed as (ncy, ncz); otherwise identical to
        grid_md.GridMD._migration_dest (see its comments for the allocation
        argument)."""
        cps, cap, box, lanes = self.cps, self.cap, self.box, self.lanes
        shp = self.grid_shape  # (ncx, C, L)

        occ_b = s.occ > 0.5
        xw = jnp.mod(s.xg, box)
        yw = jnp.mod(s.yg, box)
        zw = jnp.mod(s.zg, box)

        cx = jax.lax.broadcasted_iota(jnp.int32, shp, 0)
        col = jax.lax.broadcasted_iota(jnp.int32, shp, 2)
        cy = col // cps  # lane = cy*ncz + cz (ncy = ncz = cps)
        cz = col % cps
        cell = box / cps
        txc = jnp.clip((xw // cell).astype(jnp.int32), 0, cps - 1)
        tyc = jnp.clip((yw // cell).astype(jnp.int32), 0, cps - 1)
        tzc = jnp.clip((zw // cell).astype(jnp.int32), 0, cps - 1)
        dxc = (txc - cx + 1 + cps) % cps - 1
        dyc = (tyc - cy + 1 + cps) % cps - 1
        dzc = (tzc - cz + 1 + cps) % cps - 1
        moved_far = occ_b & (
            (jnp.abs(dxc) > 1) | (jnp.abs(dyc) > 1) | (jnp.abs(dzc) > 1)
        )
        overflow = s.overflow | jnp.any(moved_far)
        dxc = jnp.where(moved_far, 0, dxc)
        dyc = jnp.where(moved_far, 0, dyc)
        dzc = jnp.where(moved_far, 0, dzc)
        # re-derive target coords from the CLAMPED directions: dest must stay
        # consistent with the slot allocation even in flagged states (see the
        # 2D twin in grid_md._migration_dest)
        txc = (cx + dxc) % cps
        tyc = (cy + dyc) % cps
        tzc = (cz + dzc) % cps

        def roll_cells(v, dx, dy, dz):
            """out[X, :, (Y, Z)] = v[X - dx, :, (Y - dy, Z - dz)] (periodic)."""
            u = v.reshape(v.shape[:2] + (cps, cps))
            return jnp.roll(u, (dx, dy, dz), axis=(0, 2, 3)).reshape(v.shape)

        dirs = [
            (dx, dy, dz)
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)
        ]
        # Batched allocation over all 27 direction classes at once: ONE
        # one-hot stack + ONE cumsum computes every class's in-cell ranks;
        # the sequential base accumulation is an exclusive cumsum over the
        # (tiny) per-class count arrays along the class axis.
        dcode = ((dxc + 1) * 3 + (dyc + 1)) * 3 + (dzc + 1)  # class in 0..26
        dm = (
            jax.lax.broadcasted_iota(jnp.int32, (27,) + shp, 0) == dcode[None]
        ) & occ_b[None]
        dmi = dm.astype(jnp.int32)
        inc = jnp.cumsum(dmi, axis=2)  # slot axis
        ranks = inc - dmi  # exclusive in-cell rank within the class
        counts = jax.lax.slice_in_dim(inc, cap - 1, cap, axis=2)
        # per-class counts expressed at the TARGET cell, exclusive-prefixed
        # in class order = first free slot before each class arrives
        rc = jnp.stack(
            [roll_cells(counts[j], dx, dy, dz) for j, (dx, dy, dz) in enumerate(dirs)]
        )
        bases_t = jnp.cumsum(rc, axis=0) - rc
        base_src = jnp.stack(
            [
                roll_cells(bases_t[j], -dx, -dy, -dz)
                for j, (dx, dy, dz) in enumerate(dirs)
            ]
        )
        # each occupied slot belongs to exactly one class: the sum collapses
        # the one-hot stack to that class's base + rank
        target_a = jnp.where(
            occ_b, jnp.sum(jnp.where(dm, base_src + ranks, 0), axis=0), -1
        )

        slot_overflow = jnp.any((target_a >= cap) & occ_b)
        overflow = overflow | slot_overflow
        valid = occ_b & (target_a >= 0) & (target_a < cap)

        # flat destination in the same layout; OOB -> dropped
        tlane = tyc * cps + tzc
        dest = ((txc * cap + target_a) * lanes + tlane).astype(jnp.int32)
        dest = jnp.where(valid, dest, self.size)
        return xw, yw, zw, dest.reshape(-1), overflow

    @named_scope("rebuild")
    def _rebuild_migrate(self, s: GridMD3State) -> GridMD3State:
        """3D migration re-binning: between rebuilds every particle moved
        < skin/2 < cell size, so its new cell is one of the 27 neighbors.
        Allocation via rolls + small-axis cumsums (_migration_dest3); the
        slot permutation is an inverse-index scatter + one (size, F) row
        gather (grid_md.permute_rows_by_inverse; pid rides along as f32,
        exact for n < 2^24). Pure jnp, so GSPMD partitions it on the sharded
        state of ShardedGridMD3 as well. Coordinates are wrapped back into
        [0, box) here (the only place they ever are) and empty slots
        re-filled with the sentinel."""
        xw, yw, zw, dest_flat, overflow = self._migration_dest3(s)
        assert self.n < (1 << 24), "pid-in-f32 packing requires n < 2^24"
        dtype = s.xg.dtype
        fields = [xw, yw, zw, s.vxg, s.vyg, s.vzg,
                  s.fxg, s.fyg, s.fzg, s.occ,
                  s.pid.astype(dtype)]
        fills = [self.sentinel, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -1.0]
        if s.crx is not None:
            fields += [s.crx, s.cry, s.crz, s.cvx, s.cvy, s.cvz]
            fills += [0.0] * 6
        out = permute_rows_by_inverse(dest_flat, fields, fills, self.size, dtype)

        def take(k):
            return out[:, k].reshape(self.grid_shape)

        zeros = jnp.zeros(self.grid_shape, dtype)
        comp = (
            dict(crx=take(11), cry=take(12), crz=take(13),
                 cvx=take(14), cvy=take(15), cvz=take(16))
            if s.crx is not None
            else {}
        )
        occ_new = take(9)
        new_mo = self._max_occ(occ_new)
        return s.replace(
            xg=take(0), yg=take(1), zg=take(2),
            vxg=take(3), vyg=take(4), vzg=take(5),
            fxg=take(6), fyg=take(7), fzg=take(8),
            occ=occ_new,
            pid=take(10).astype(jnp.int32),
            dispx=zeros, dispy=zeros, dispz=zeros,
            dmax2=jnp.zeros((), dtype),
            overflow=overflow,
            max_occ=new_mo,
            **comp,
        )

    # -- rebuild (sort-based oracle) ------------------------------------------
    def _rebuild(self, s: GridMD3State) -> GridMD3State:
        cps, cap = self.cps, self.cap
        occ = s.occ.reshape(-1)
        x = jnp.mod(s.xg, self.box).reshape(-1)
        y = jnp.mod(s.yg, self.box).reshape(-1)
        z = jnp.mod(s.zg, self.box).reshape(-1)
        n_cells = cps * cps * cps

        def cellc(v):
            return jnp.clip((v // (self.box / cps)).astype(jnp.int32), 0, cps - 1)

        ids = jnp.where(
            occ > 0.5, (cellc(x) * cps + cellc(y)) * cps + cellc(z), n_cells
        )
        order = jnp.argsort(ids)
        sorted_ids = ids[order]
        seg = jnp.searchsorted(sorted_ids, sorted_ids, side="left")
        rank = jnp.arange(self.size, dtype=jnp.int32) - seg.astype(jnp.int32)
        real = sorted_ids < n_cells
        overflow = s.overflow | jnp.any(real & (rank >= cap))
        rank = jnp.minimum(rank, cap - 1)
        cxs = sorted_ids // (cps * cps)
        lane = sorted_ids % (cps * cps)
        new_slot = (cxs * cap + rank) * self.lanes + lane
        new_slot = jnp.where(real, new_slot, self.size)  # drop empties

        def scat(v, fill=0.0, dtype=None):
            vv = v.reshape(-1)[order]
            out = jnp.full((self.size,), fill, dtype or v.dtype)
            return out.at[new_slot].set(vv, mode="drop").reshape(self.grid_shape)

        zeros = jnp.zeros(self.grid_shape, s.xg.dtype)
        comp = (
            dict(crx=scat(s.crx), cry=scat(s.cry), crz=scat(s.crz),
                 cvx=scat(s.cvx), cvy=scat(s.cvy), cvz=scat(s.cvz))
            if s.crx is not None
            else {}
        )
        occ_new = scat(s.occ)
        new_mo = self._max_occ(occ_new)
        return s.replace(
            xg=scat(x.reshape(self.grid_shape), fill=self.sentinel),
            yg=scat(y.reshape(self.grid_shape)),
            zg=scat(z.reshape(self.grid_shape)),
            vxg=scat(s.vxg), vyg=scat(s.vyg), vzg=scat(s.vzg),
            fxg=scat(s.fxg), fyg=scat(s.fyg), fzg=scat(s.fzg),
            occ=occ_new,
            pid=scat(s.pid, fill=-1, dtype=jnp.int32),
            dispx=zeros, dispy=zeros, dispz=zeros,
            dmax2=jnp.zeros((), s.xg.dtype),
            overflow=overflow,
            max_occ=new_mo,
            **comp,
        )

    def _needs_rebuild(self, s: GridMD3State, frac: float = 0.5) -> jax.Array:
        return ~(s.dmax2 <= (frac * self.skin) ** 2)

    # -- MD step ---------------------------------------------------------------
    @staticmethod
    def _kadd(x, c, inc):
        y = inc - c
        t = x + y
        c = (t - x) - y
        return t, c

    def _make_window(
        self, force_fn, n_inner: int, reduce_max=None, thermostat=None, rng_fold=None
    ):
        """Leapfrog window, 3D (see grid_md.GridMD._make_window — identical
        scheme, one force call + one fused elementwise pass per step, skin
        monitor via displacement accumulators, violation flagged at skin/2;
        ``thermostat=(gamma, kT)`` -> BAOAB Langevin, occupancy-masked
        noise, velocity compensation bypassed; ``rng_fold`` decorrelates
        shard-local noise streams)."""
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

        def window(s: GridMD3State) -> GridMD3State:
            if thermostat is not None and s.rng is None:
                raise ValueError(
                    "Langevin window needs a PRNG stream: init(..., seed=...)"
                )
            mo = s.max_occ  # constant between rebuilds (binning is fixed)
            vhx = s.vxg + 0.5 * dt * s.fxg
            vhy = s.vyg + 0.5 * dt * s.fyg
            vhz = s.vzg + 0.5 * dt * s.fzg
            dm0 = s.dispx**2 + s.dispy**2 + s.dispz**2
            carry = (
                s.xg, s.yg, s.zg, s.crx, s.cry, s.crz,
                vhx, vhy, vhz, s.cvx, s.cvy, s.cvz,
                s.dispx, s.dispy, s.dispz, dm0, s.fxg, s.fyg, s.fzg,
            )

            def body(i, c):
                (x, y, z, crx, cry, crz, vhx, vhy, vhz, cvx, cvy, cvz,
                 dpx, dpy, dpz, dm, fx, fy, fz) = c
                if thermostat is None:
                    incx, incy, incz = dt * vhx, dt * vhy, dt * vhz
                else:
                    # A O A (see grid_md): OU-refresh between two half-drifts
                    k = rng_fold(jax.random.fold_in(s.rng, i))
                    xi = jax.random.normal(k, (3,) + x.shape, x.dtype)
                    vpx = c1 * vhx + c2 * (xi[0] * s.occ)
                    vpy = c1 * vhy + c2 * (xi[1] * s.occ)
                    vpz = c1 * vhz + c2 * (xi[2] * s.occ)
                    incx = 0.5 * dt * (vhx + vpx)
                    incy = 0.5 * dt * (vhy + vpy)
                    incz = 0.5 * dt * (vhz + vpz)
                    vhx, vhy, vhz = vpx, vpy, vpz
                if comp:
                    x, crx = kadd(x, crx, incx)
                    y, cry = kadd(y, cry, incy)
                    z, crz = kadd(z, crz, incz)
                else:
                    x, y, z = x + incx, y + incy, z + incz
                dpx, dpy, dpz = dpx + incx, dpy + incy, dpz + incz
                dm = jnp.maximum(dm, dpx * dpx + dpy * dpy + dpz * dpz)
                fx, fy, fz = force_fn(x, y, z, max_occ=mo)
                if comp and not pos_only and thermostat is None:
                    vhx, cvx = kadd(vhx, cvx, dt * fx)
                    vhy, cvy = kadd(vhy, cvy, dt * fy)
                    vhz, cvz = kadd(vhz, cvz, dt * fz)
                else:
                    vhx, vhy, vhz = vhx + dt * fx, vhy + dt * fy, vhz + dt * fz
                return (x, y, z, crx, cry, crz, vhx, vhy, vhz, cvx, cvy, cvz,
                        dpx, dpy, dpz, dm, fx, fy, fz)

            c = jax.lax.fori_loop(0, n_inner, body, carry)
            (x, y, z, crx, cry, crz, vhx, vhy, vhz, cvx, cvy, cvz,
             dpx, dpy, dpz, dm, fx, fy, fz) = c
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
                xg=x, yg=y, zg=z,
                vxg=vhx - 0.5 * dt * fx,
                vyg=vhy - 0.5 * dt * fy,
                vzg=vhz - 0.5 * dt * fz,
                fxg=fx, fyg=fy, fzg=fz,
                crx=crx, cry=cry, crz=crz, cvx=cvx, cvy=cvy, cvz=cvz,
                dispx=dpx, dispy=dpy, dispz=dpz,
                dmax2=dmax2,
                overflow=s.overflow | violation,
                time=s.time + n_inner * dt,
                **rng,
            )

        return window

    def _window_builder(self, n_inner: int, thermostat=None):
        """Integrator-window factory hook (see grid_md.GridMD._window_builder):
        the sharded subclass overrides this one method — halo force +
        shard_map wrapper — and inherits every driver below."""
        return self._make_window(self.force_kernel, n_inner, thermostat=thermostat)

    def step_nocheck(self, s: GridMD3State) -> GridMD3State:
        return self._window_builder(1)(s)

    def step(self, s: GridMD3State) -> GridMD3State:
        s = jax.lax.cond(self._needs_rebuild(s), self._rebuild_migrate, lambda t: t, s)
        return self.step_nocheck(s)

    def make_chunk_step(self, n_inner: int, gate_frac: float = 0.25, thermostat=None):
        """``chunk(s) -> s``: one displacement-gated rebuild + a branch-free
        n_inner-step leapfrog window (see grid_md.GridMD.make_chunk_step for
        the gate/window sizing contract; ``thermostat=(gamma, kT)`` -> BAOAB
        Langevin windows)."""
        window = self._window_builder(n_inner, thermostat=thermostat)

        def chunk(s: GridMD3State) -> GridMD3State:
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
        """Cond-free nested-while production driver — 3D twin of
        grid_md.GridMD.make_production_run (see there for the rationale and
        the exact-step/trailing-rebuild contract)."""
        assert n_steps % n_inner == 0, (n_steps, n_inner)
        window = self._window_builder(n_inner, thermostat=thermostat)

        def run(s: GridMD3State) -> GridMD3State:
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
        """Fixed-cadence production driver: a single fori_loop of
        ``rebuild -> cadence-step window`` blocks — zero gate evaluation and
        zero dynamic-while machinery.

        Safety demotes from the displacement gate to the window's existing
        skin/2 violation flag: a cadence outsized for the actual temperature
        raises ``overflow`` loudly (tests assert), never loses pairs
        silently. Use :meth:`auto_cadence` for a margin-checked default and
        only on EQUILIBRATED states — transients (lattice melt) drift
        faster than the kT-derived horizon. ``n_steps % cadence`` trailing
        steps run as one remainder block."""
        assert cadence >= 1, cadence
        assert thermostat is None, (
            "fixed-cadence driver is NVE-only; Langevin runs use the gated "
            "chunk driver (make_chunk_step) where the per-window RNG fold "
            "is already paid"
        )
        window = self._window_builder(cadence)
        nb, rem = divmod(n_steps, cadence)
        if rem:
            tail = self._window_builder(rem)

        def run(s: GridMD3State) -> GridMD3State:
            def body(i, t):
                return window(self._rebuild_migrate(t))

            s = jax.lax.fori_loop(0, nb, body, s)
            if rem:
                s = tail(self._rebuild_migrate(s))
            return s

        return run

    def auto_cadence(self, kt: float = 1.0, n_steps: int = 100_000) -> int:
        """Rebuild cadence for :meth:`make_production_run_fixed`, sized by
        Gaussian extreme-value statistics over the WHOLE RUN: the fastest
        displacement between rebuilds is ~ballistic, ``R * |v| * dt``, and
        the max of ``N * n_steps`` one-axis speed samples is
        ``sqrt(2 ln(N n_steps)) * sqrt(kT)`` — the cadence keeps that
        excursion under ``0.5 * skin`` with a 7% buffer. The run-length
        term matters: a cadence sized for a short run trips the skin/2 flag
        in a long one. Pass the actual production length; the log makes
        the result insensitive to it. If the flag still trips (loud, never
        silent), fall back to the gated driver."""
        samples = max(float(self.n) * max(n_steps, 1), math.e)
        vmax = math.sqrt(2.0 * math.log(samples)) * kt**0.5
        return max(1, int(0.93 * 0.5 * self.skin / (vmax * self.dt)))

    def auto_chunk_params(self, kt: float = 1.0) -> Tuple[int, float]:
        """``(n_inner, gate_frac)`` sized together — see
        grid_md.GridMD.auto_chunk_params (same rule and preferences)."""
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
        """Maxwell-tail rebuild cadence (grid_md.GridMD.auto_inner_steps)."""
        vmax = vmax_sigmas * kt**0.5
        k = int(((0.5 - gate_frac) * self.skin) / (vmax * self.dt))
        return max(1, k)

    # -- observables / export ---------------------------------------------------
    def kinetic_energy(self, s: GridMD3State) -> jax.Array:
        return 0.5 * jnp.sum((s.vxg**2 + s.vyg**2 + s.vzg**2) * s.occ)

    def potential_energy(self, s: GridMD3State) -> jax.Array:
        _, _, _, e, _ = self.energy_kernel(s.xg, s.yg, s.zg, max_occ=s.max_occ)
        return 0.5 * jnp.sum(e)

    def virial(self, s: GridMD3State) -> jax.Array:
        """Pair virial (see grid_md.GridMD.virial)."""
        _, _, _, _, w = self.energy_kernel(s.xg, s.yg, s.zg, max_occ=s.max_occ)
        return 0.5 * jnp.sum(w)

    def pressure(self, s: GridMD3State) -> jax.Array:
        """Instantaneous virial pressure ``P = (2*KE + W) / (3 * V)``."""
        return (2.0 * self.kinetic_energy(s) + self.virial(s)) / (
            3.0 * self.box**3
        )

    def positions(self, s: GridMD3State) -> jax.Array:
        """(N, 3) positions in particle order, wrapped into [0, box)."""
        return self._gather3(s.xg, s.yg, s.zg, s.pid, wrap=True)

    def velocities(self, s: GridMD3State) -> jax.Array:
        return self._gather3(s.vxg, s.vyg, s.vzg, s.pid, wrap=False)

    def forces(self, s: GridMD3State) -> jax.Array:
        """(N, 3) reaction-folded total forces in particle order (testing /
        sampling accessor — the hot loop never leaves the grid layout)."""
        return self._gather3(s.fxg, s.fyg, s.fzg, s.pid, wrap=False)

    def _gather3(self, a, b, c, pid, wrap: bool) -> jax.Array:
        pid = pid.reshape(-1)
        tgt = jnp.where(pid >= 0, pid, self.n)
        out = jnp.zeros((self.n + 1, 3), a.dtype)
        out = out.at[tgt, 0].set(a.reshape(-1), mode="drop")
        out = out.at[tgt, 1].set(b.reshape(-1), mode="drop")
        out = out.at[tgt, 2].set(c.reshape(-1), mode="drop")
        out = out[: self.n]
        return jnp.mod(out, self.box) if wrap else out

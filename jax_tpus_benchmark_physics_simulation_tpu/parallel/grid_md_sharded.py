"""Multi-chip grid-resident LJ MD: spatial domain decomposition.

The single-chip grid engine (ops.kernels.grid_md) holds the cell grid
(ncx, C, ncy_pad) on one device. Here the cell-ROW axis is sharded over a
1-D mesh: each device owns ncx/P contiguous rows of the physical domain.

Per inner step (shard_map, all local except two one-row ppermutes):
- halo exchange: each device sends its first row of (x, y) to its left
  neighbor, providing the "next row" the Newton force kernel needs (the seam
  device adds +box to the received x row — the same periodic-seam handling
  the single-chip kernel does internally via its program index);
- the cell force (``.raw``) runs on the local rows;
- the Newton reaction buffer's last row is the force the local edge exerts
  on the neighbor's first row — one more ppermute delivers it;
- the leapfrog kick+drift is elementwise-local; the displacement monitor
  reduces with a pmax at window end.

The integrator window itself is GridMD._make_window — the sharded engine
injects only its halo force function and the pmax reduction, so plain,
Kahan-compensated, and compensated='positions' configs execute IDENTICAL
arithmetic on one chip and on a mesh.

Cell re-binning (migration) runs OUTSIDE shard_map as the single-device
engine's plain-jnp gather rebuild on the GSPMD-sharded state every
~n_inner steps: XLA inserts the collectives for the cross-boundary
rolls/scatters/gathers automatically. This keeps the allocation code
identical to the single-device version.

Validated against the single-device engine on the 8-virtual-device CPU mesh
(tests/test_grid_md_sharded.py) and on four GPUs by ``chip_smoke.py --four``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import CellGridFn
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_force import (
    make_grid_force,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import (
    GridMD,
    GridMDState,
)


class ShardedGridMD(GridMD):
    """GridMD with the cell-row axis sharded over ``mesh`` (axis name 'x').

    Usage: build like GridMD plus a mesh; ``shard_state`` places a state;
    ``make_chunk_step`` returns a jit-ready chunk whose inner loop is a
    shard_map program.
    """

    def __init__(
        self,
        grid_fn: CellGridFn,
        mesh: Mesh,
        axis_name: str = "x",
        sigma: float = 1.0,
        epsilon: float = 1.0,
        dt: float = 1e-3,
        compensated: bool = False,
    ):
        super().__init__(
            grid_fn,
            sigma=sigma,
            epsilon=epsilon,
            dt=dt,
            compensated=compensated,
        )
        self.mesh = mesh
        self.axis_name = axis_name
        self.n_shards = mesh.shape[axis_name]
        if self.cps % self.n_shards:
            raise ValueError(
                f"cells_per_side {self.cps} not divisible by mesh size {self.n_shards}"
            )
        self.rows_local = self.cps // self.n_shards
        # local-row forces (explicit-halo mode)
        self._local_force = make_grid_force(
            grid_fn, n_rows=self.rows_local, **self._force_kw
        ).raw
        self._local_energy = make_grid_force(
            grid_fn, n_rows=self.rows_local, with_energy=True, **self._force_kw
        ).raw

    def prepare(self, state: GridMDState) -> GridMDState:
        return self.shard_state(state)

    # -- sharding helpers -----------------------------------------------------
    def _state_specs(self, state: GridMDState):
        def spec(leaf):
            if hasattr(leaf, "ndim") and leaf.ndim == 3:
                return P(self.axis_name)
            return P()

        return jax.tree.map(spec, state)

    def shard_state(self, state: GridMDState) -> GridMDState:
        specs = self._state_specs(state)
        return jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(self.mesh, s)), state, specs
        )

    # -- halo force (called inside shard_map) ----------------------------------
    def _with_halo(self, v: jax.Array, seam_delta: float = 0.0) -> jax.Array:
        """Next-row array for the local block: local rows 1.. plus the next
        device's first row. ``seam_delta``: added to the received halo row on
        the last device, whose neighbor sits across the periodic seam (pass
        ``box`` for the x coordinate)."""
        ax, p = self.axis_name, self.n_shards
        fwd = [(i, (i - 1) % p) for i in range(p)]  # row 0 -> left neighbor
        halo = lax.ppermute(v[0:1], ax, fwd)  # next device's first row
        if seam_delta:
            halo = halo + jnp.where(
                lax.axis_index(ax) == p - 1, seam_delta, 0.0
            ).astype(halo.dtype)
        return jnp.concatenate([v[1:], halo], axis=0)

    def _shift_reaction(self, r: jax.Array) -> jax.Array:
        """Reaction row i is destined for row i+1; the last row crosses to
        the next device."""
        ax, p = self.axis_name, self.n_shards
        bwd = [(i, (i + 1) % p) for i in range(p)]  # row -1 -> right neighbor
        halo = lax.ppermute(r[-1:], ax, bwd)  # prev device's last row
        return jnp.concatenate([halo, r[:-1]], axis=0)

    def _halo_force(self, xg, yg):
        fx, fy, rfx, rfy = self._local_force(
            xg, self._with_halo(xg, seam_delta=self.box), yg, self._with_halo(yg)
        )
        return fx + self._shift_reaction(rfx), fy + self._shift_reaction(rfy)

    # -- sharded windows --------------------------------------------------------
    def _window_builder(self, n_inner: int, thermostat=None):
        """Sharded window: the local halo-force leapfrog window wrapped in
        shard_map (specs taken from the state at trace time). The base-class
        drivers — make_chunk_step's gated chunk AND make_production_run's
        cond-free nested while — build every window through this hook, so
        their rebuild conds/loops run at GSPMD level (rebuild on the
        GSPMD-sharded global arrays, collectives auto) with identical
        arithmetic to the single-chip engine.
        ``thermostat=(gamma, kT)``: BAOAB Langevin windows — each shard
        draws its own noise stream (the replicated state key folded with
        the shard index)."""
        ax = self.axis_name
        window = self._make_window(
            self._halo_force,
            n_inner,
            reduce_max=lambda v: lax.pmax(v, ax),
            thermostat=thermostat,
            rng_fold=lambda k: jax.random.fold_in(k, lax.axis_index(ax)),
        )

        def wrapped(s: GridMDState) -> GridMDState:
            specs = self._state_specs(s)
            return jax.shard_map(
                window,
                mesh=self.mesh,
                in_specs=(specs,),
                out_specs=specs,
                check_vma=False,
            )(s)

        return wrapped

    def force_once(self, s: GridMDState):
        """Single sharded force evaluation (for tests): total (fx, fy)."""
        arr_spec = P(self.axis_name)
        return jax.shard_map(
            self._halo_force,
            mesh=self.mesh,
            in_specs=(arr_spec, arr_spec),
            out_specs=(arr_spec, arr_spec),
            check_vma=False,
        )(s.xg, s.yg)

    def potential_energy(self, s: GridMDState) -> jax.Array:
        """On-demand sharded energy pass (psum-reduced scalar)."""
        arr_spec = P(self.axis_name)

        def local_pe(xg, yg):
            out = self._local_energy(
                xg, self._with_halo(xg, seam_delta=self.box), yg, self._with_halo(yg)
            )
            e = out[4] + self._shift_reaction(out[5])
            return lax.psum(0.5 * jnp.sum(e), self.axis_name)

        return jax.shard_map(
            local_pe,
            mesh=self.mesh,
            in_specs=(arr_spec, arr_spec),
            out_specs=P(),
            check_vma=False,
        )(s.xg, s.yg)

    def virial(self, s: GridMDState) -> jax.Array:
        """Sharded pair virial (psum-reduced; see grid_md.GridMD.virial)."""
        arr_spec = P(self.axis_name)

        def local_w(xg, yg):
            out = self._local_energy(
                xg, self._with_halo(xg, seam_delta=self.box), yg, self._with_halo(yg)
            )
            w = out[6] + self._shift_reaction(out[7])
            return lax.psum(0.5 * jnp.sum(w), self.axis_name)

        return jax.shard_map(
            local_w,
            mesh=self.mesh,
            in_specs=(arr_spec, arr_spec),
            out_specs=P(),
            check_vma=False,
        )(s.xg, s.yg)

    def pressure(self, s: GridMDState) -> jax.Array:
        """Instantaneous virial pressure (see grid_md.GridMD.pressure)."""
        return (2.0 * self.kinetic_energy(s) + self.virial(s)) / (
            2.0 * self.box**2
        )

"""Multi-chip 3D grid-resident LJ MD: spatial domain decomposition.

3D counterpart of parallel.grid_md_sharded (read that docstring first — the
scheme is identical). The x-ROW axis of the packed (ncx, C, P) layout is
sharded over a 1-D mesh: each device owns ncx/p contiguous x-slabs of the
physical domain. Per inner step (shard_map, all local except two one-row
ppermutes):

- halo exchange: each device ppermutes its first x-row of (x, y, z) to its
  left neighbor (the seam device adds +box to the received x row);
- the 3D cell force (``.raw``) runs on the local rows;
- the Newton reaction buffer's last row is delivered to the right neighbor
  by one more ppermute;
- the leapfrog kick+drift is elementwise-local; the displacement monitor
  reduces with a pmax at window end.

The integrator window is GridMD3._make_window with the halo force function
and pmax injected, so single-chip and sharded runs execute IDENTICAL
arithmetic. Migration re-binning runs OUTSIDE shard_map as plain jnp on the
GSPMD-sharded state (XLA inserts the cross-boundary collectives).

Validated against the single-device 3D engine on the virtual CPU mesh
(tests/test_grid_md3_sharded.py) and on four GPUs by
``chip_smoke.py --four``. Beyond-reference scope: the reference MD
is dim=2-hardcoded AND single-device (molecular_dynamics_jax_single-host_
workload.py:26).
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
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import (
    GridMD3,
    GridMD3State,
)


class ShardedGridMD3(GridMD3):
    """GridMD3 with the x-row axis sharded over ``mesh`` (axis name 'x')."""

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
        self._local_force = make_grid_force(
            grid_fn, n_rows=self.rows_local, **self._force_kw
        ).raw
        self._local_energy = make_grid_force(
            grid_fn, n_rows=self.rows_local, with_energy=True, **self._force_kw
        ).raw

    def prepare(self, state: GridMD3State) -> GridMD3State:
        return self.shard_state(state)

    # -- sharding helpers -----------------------------------------------------
    def _state_specs(self, state: GridMD3State):
        def spec(leaf):
            if hasattr(leaf, "ndim") and leaf.ndim == 3:
                return P(self.axis_name)
            return P()

        return jax.tree.map(spec, state)

    def shard_state(self, state: GridMD3State) -> GridMD3State:
        specs = self._state_specs(state)
        return jax.tree.map(
            lambda x, s: jax.device_put(x, NamedSharding(self.mesh, s)), state, specs
        )

    # -- halo force (called inside shard_map) ----------------------------------
    def _with_halo(self, v: jax.Array, seam_delta: float = 0.0) -> jax.Array:
        ax, p = self.axis_name, self.n_shards
        fwd = [(i, (i - 1) % p) for i in range(p)]  # row 0 -> left neighbor
        halo = lax.ppermute(v[0:1], ax, fwd)
        if seam_delta:
            halo = halo + jnp.where(
                lax.axis_index(ax) == p - 1, seam_delta, 0.0
            ).astype(halo.dtype)
        return jnp.concatenate([v[1:], halo], axis=0)

    def _shift_reaction(self, r: jax.Array) -> jax.Array:
        ax, p = self.axis_name, self.n_shards
        bwd = [(i, (i + 1) % p) for i in range(p)]
        halo = lax.ppermute(r[-1:], ax, bwd)
        return jnp.concatenate([halo, r[:-1]], axis=0)

    def _halo_force(self, xg, yg, zg, max_occ=None):
        fx, fy, fz, rfx, rfy, rfz = self._local_force(
            xg, self._with_halo(xg, seam_delta=self.box),
            yg, self._with_halo(yg),
            zg, self._with_halo(zg),
            max_occ=max_occ,
        )
        return (
            fx + self._shift_reaction(rfx),
            fy + self._shift_reaction(rfy),
            fz + self._shift_reaction(rfz),
        )

    # -- sharded windows --------------------------------------------------------
    def _window_builder(self, n_inner: int, thermostat=None):
        """Sharded window hook (see grid_md_sharded.ShardedGridMD.
        _window_builder): base-class drivers — gated chunk, cond-free
        production while-loops, fixed-cadence fori — run at GSPMD level and
        build each window through this shard_map wrapper."""
        ax = self.axis_name
        window = self._make_window(
            self._halo_force,
            n_inner,
            reduce_max=lambda v: lax.pmax(v, ax),
            thermostat=thermostat,
            rng_fold=lambda k: jax.random.fold_in(k, lax.axis_index(ax)),
        )

        def wrapped(s: GridMD3State) -> GridMD3State:
            specs = self._state_specs(s)
            return jax.shard_map(
                window,
                mesh=self.mesh,
                in_specs=(specs,),
                out_specs=specs,
                check_vma=False,
            )(s)

        return wrapped

    def force_once(self, s: GridMD3State):
        """Single sharded force evaluation (for tests): (fx, fy, fz)."""
        arr_spec = P(self.axis_name)
        return jax.shard_map(
            self._halo_force,
            mesh=self.mesh,
            in_specs=(arr_spec,) * 3 + (P(),),
            out_specs=(arr_spec,) * 3,
            check_vma=False,
        )(s.xg, s.yg, s.zg, s.max_occ)

    def potential_energy(self, s: GridMD3State) -> jax.Array:
        """On-demand sharded energy pass (psum-reduced scalar)."""
        arr_spec = P(self.axis_name)

        def local_pe(xg, yg, zg, max_occ):
            out = self._local_energy(
                xg, self._with_halo(xg, seam_delta=self.box),
                yg, self._with_halo(yg),
                zg, self._with_halo(zg),
                max_occ=max_occ,
            )
            e = out[6] + self._shift_reaction(out[7])
            return lax.psum(0.5 * jnp.sum(e), self.axis_name)

        return jax.shard_map(
            local_pe,
            mesh=self.mesh,
            in_specs=(arr_spec,) * 3 + (P(),),
            out_specs=P(),
            check_vma=False,
        )(s.xg, s.yg, s.zg, s.max_occ)

    def virial(self, s: GridMD3State) -> jax.Array:
        """Sharded pair virial (psum-reduced; see grid_md.GridMD.virial)."""
        arr_spec = P(self.axis_name)

        def local_w(xg, yg, zg, max_occ):
            out = self._local_energy(
                xg, self._with_halo(xg, seam_delta=self.box),
                yg, self._with_halo(yg),
                zg, self._with_halo(zg),
                max_occ=max_occ,
            )
            w = out[8] + self._shift_reaction(out[9])
            return lax.psum(0.5 * jnp.sum(w), self.axis_name)

        return jax.shard_map(
            local_w,
            mesh=self.mesh,
            in_specs=(arr_spec,) * 3 + (P(),),
            out_specs=P(),
            check_vma=False,
        )(s.xg, s.yg, s.zg, s.max_occ)

    def pressure(self, s: GridMD3State) -> jax.Array:
        """Instantaneous virial pressure (see grid_md3.GridMD3.pressure)."""
        return (2.0 * self.kinetic_energy(s) + self.virial(s)) / (
            3.0 * self.box**3
        )

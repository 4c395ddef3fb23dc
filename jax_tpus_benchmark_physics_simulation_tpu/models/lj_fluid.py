"""Workload: Lennard-Jones fluid MD (NVE, velocity-Verlet, PBC).

Reference: molecular_dynamics_jax_single-host_workload.py (216 LoC) — 2D LJ,
full O(N^2) pair matrix, no cutoff/neighbor lists, fori_loop phases, on-device
RDF. This module keeps the same physics and defaults while dispatching the
force evaluation across four implementations behind one interface:

- ``dense_xla``    reference-fidelity O(N^2) (oracle; molecular_dynamics...:50-64)
- ``neighbor``     O(N*K) Verlet-list gather path
- ``cell``         roll-based cell-grid path (gather-free), 2D/3D
- ``grid``         grid-RESIDENT engine (auto-shards over multiple devices
                   via parallel.grid_md_sharded / grid_md3_sharded)

This is the north-star metric path (particle-steps/sec); measured numbers
are in PERF.md.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig
from jax_tpus_benchmark_physics_simulation_tpu.core.runner import run_steps, run_trajectory
from jax_tpus_benchmark_physics_simulation_tpu.core.state import ParticleState
from jax_tpus_benchmark_physics_simulation_tpu.ops.forces import LennardJones, wrap
from jax_tpus_benchmark_physics_simulation_tpu.ops.integrators import velocity_verlet
from jax_tpus_benchmark_physics_simulation_tpu.ops.observables import (
    kinetic_energy,
    radial_distribution,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.observables.rdf import (
    _DEFAULT_MAX_PARTICLES as _RDF_MAX_PARTICLES,
)


def init_state(cfg: MDConfig, key: Optional[jax.Array] = None) -> ParticleState:
    """Initialization.

    ``uniform``: the reference's R ~ U(0, box), V ~ N(0,1) sqrt(kT) with the
    same key-split structure (molecular_dynamics...:133-136). Note this allows
    particle overlaps (huge initial LJ forces) — kept for parity.
    ``lattice``: square/cubic lattice placement (no overlaps) — the sane
    start the reference lacks (SURVEY.md §2c).
    """
    dtype = jnp.dtype(cfg.dtype)
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    key, r_key, v_key = jax.random.split(key, 3)
    if cfg.init == "uniform":
        r = jax.random.uniform(r_key, (cfg.n, cfg.dim), dtype=dtype) * cfg.box_size
    elif cfg.init == "lattice":
        per_side = int(np.ceil(cfg.n ** (1.0 / cfg.dim)))
        spacing = cfg.box_size / per_side
        grid = jnp.arange(per_side, dtype=dtype) * spacing + 0.5 * spacing
        mesh = jnp.stack(jnp.meshgrid(*([grid] * cfg.dim), indexing="ij"), axis=-1)
        r = mesh.reshape(-1, cfg.dim)[: cfg.n]
    else:
        raise ValueError(f"unknown init: {cfg.init}")
    v = jax.random.normal(v_key, (cfg.n, cfg.dim), dtype=dtype) * jnp.sqrt(cfg.kt)
    if cfg.remove_com_drift:
        v = v - jnp.mean(v, axis=0, keepdims=True)
    return ParticleState.create(r, v)


def make_potential(cfg: MDConfig) -> LennardJones:
    return LennardJones(
        sigma=cfg.sigma, epsilon=cfg.epsilon, box=cfg.box_size, cutoff=cfg.cutoff
    )


SKIN_DEFAULT = 0.4  # measured 2D/list-path gate optimum


def resolve_skin(
    cfg: MDConfig, impl: Optional[str] = None, n_devices: Optional[int] = None
) -> float:
    """Concrete Verlet skin for ``cfg`` (``cfg.skin`` unless it is None).

    Auto policy for the grid engine: the 3D engine takes the DENSEST cell
    geometry (fewer pair tests per particle, more frequent rebuilds): the
    largest cells-per-side with skin >= max(0.1, 80*sqrt(kT)*dt) (the
    dynamic floor keeps the rebuild cadence ``auto_chunk_params`` computes
    >= 1 step), never coarser than the 0.4-skin geometry. The 2D engine
    keeps the 0.4-skin geometry. On several devices cells-per-side is
    rounded down to a multiple of ``n_devices`` so the sharded engine stays
    available. Every other path uses 0.4."""
    if cfg.skin is not None:
        return cfg.skin
    if impl is None:
        impl = resolve_impl(cfg)
    if impl != "grid" or cfg.cutoff is None:
        return SKIN_DEFAULT
    if n_devices is None:
        n_devices = jax.device_count()
    box = cfg.box_size
    floor = max(0.1, 80.0 * cfg.kt**0.5 * cfg.dt)

    def _cps(skin: float) -> int:
        c = int(box / (cfg.cutoff + skin))
        if n_devices > 1 and c >= n_devices:
            c -= c % n_devices
        return c

    if cfg.dim == 3:
        cps = max(_cps(floor), _cps(SKIN_DEFAULT))
    else:
        cps = _cps(SKIN_DEFAULT)
        if cps == int(box / (cfg.cutoff + SKIN_DEFAULT)):
            return SKIN_DEFAULT
    if cps < 3:
        return SKIN_DEFAULT
    return box / cps - cfg.cutoff


def resolve_impl(cfg: MDConfig) -> str:
    impl = cfg.force_impl
    if impl == "auto":
        skin0 = cfg.skin if cfg.skin is not None else SKIN_DEFAULT
        cps = 0 if cfg.cutoff is None else int(cfg.box_size / (cfg.cutoff + skin0))
        if cfg.cutoff is not None and cfg.n >= 4096 and cps >= 3:
            # grid-resident MD (2D and 3D engines)
            impl = "grid" if cfg.dim in (2, 3) else "cell"
        elif cfg.cutoff is not None and cfg.n >= 4096:
            impl = "neighbor"
        else:
            impl = "dense_xla"
    if impl in ("neighbor", "cell", "grid") and cfg.cutoff is None:
        raise ValueError(f"force_impl={impl!r} requires a cutoff")
    if impl == "grid" and cfg.dim not in (2, 3):
        raise ValueError("force_impl='grid' supports dim 2 and 3")
    return impl


def _make_grid_md(cfg: MDConfig):
    from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
        make_cell_grid_fn,
    )
    from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD

    n_dev = jax.device_count()
    gf = make_cell_grid_fn(
        cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim,
        skin=resolve_skin(cfg, "grid", n_dev), rho=cfg.rho,
    )
    kw = dict(sigma=cfg.sigma, epsilon=cfg.epsilon, dt=cfg.dt, compensated=cfg.compensated)
    if cfg.dim == 3:
        from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import (
            GridMD3,
        )

        if n_dev > 1 and gf.cells_per_side % n_dev == 0:
            # auto-shard x-slabs over all devices (halo-exchange engine)
            from jax_tpus_benchmark_physics_simulation_tpu.parallel.grid_md3_sharded import (
                ShardedGridMD3,
            )
            from jax_tpus_benchmark_physics_simulation_tpu.parallel.mesh import make_mesh

            return ShardedGridMD3(gf, make_mesh(n_dev, axis_name="x"), **kw)
        return GridMD3(gf, **kw)
    if n_dev > 1 and gf.cells_per_side % n_dev == 0:
        # auto-shard cell rows over all devices (halo-exchange engine)
        from jax_tpus_benchmark_physics_simulation_tpu.parallel.grid_md_sharded import (
            ShardedGridMD,
        )
        from jax_tpus_benchmark_physics_simulation_tpu.parallel.mesh import make_mesh

        return ShardedGridMD(gf, make_mesh(n_dev, axis_name="x"), **kw)
    return GridMD(gf, **kw)


def _grid_thermostat(cfg: MDConfig):
    """``(gamma, kT)`` for BAOAB Langevin windows, or None for NVE.
    Validation happens in :func:`run`/CLI; here we just translate."""
    if cfg.thermostat == "langevin":
        return (cfg.gamma, cfg.kt)
    if cfg.thermostat not in ("none", None):
        raise ValueError(f"unknown thermostat {cfg.thermostat!r} (none | langevin)")
    return None


def _grid_seed(cfg: MDConfig):
    """PRNG seed for stochastic windows (decorrelated from the init-velocity
    stream by a fixed offset); None keeps the state rng-free for NVE."""
    return cfg.seed + 0x5EED if cfg.thermostat == "langevin" else None


def _grid_inner_steps(cfg: MDConfig, md) -> Tuple[int, float]:
    """Rebuild cadence: ``(n_inner, gate_frac)`` from the engine's coupled
    sizing (high gate = fewer expensive migration rebuilds), with the window
    clipped to the largest divisor of sample_every (so production sampling
    aligns with chunks; a SHORTER window at the same gate is always safe)."""
    auto, gate = md.auto_chunk_params(kt=cfg.kt)
    k = min(auto, cfg.sample_every)
    while cfg.sample_every % k:
        k -= 1
    return max(1, k), gate


def make_force_fn(cfg: MDConfig):
    """Dense force dispatch (``R -> F``). The neighbor path has extra carried
    state and is handled in :func:`build_step`. All implementations compute
    the same physics (cross-checked in tests/test_md_impls.py and
    tests/test_neighbor_list.py)."""
    lj = make_potential(cfg)
    impl = resolve_impl(cfg)

    if impl == "dense_xla":
        return lj.force
    raise ValueError(f"unknown force_impl: {cfg.force_impl}")


def build_step(cfg: MDConfig):
    """Returns ``(init_fn, step_fn, get_state)`` over an opaque carry.

    Dense paths: carry == ParticleState. Neighbor path: carry ==
    (ParticleState, NeighborList) with skin-gated rebuilds fused into the
    step (one kick-drift-kick + maybe_rebuild per step, still a single
    device program under scan).
    """
    box = cfg.box_size
    impl = resolve_impl(cfg)

    if impl not in ("neighbor", "cell"):
        force_fn = make_force_fn(cfg)
        init_fn, step_fn = velocity_verlet(force_fn, cfg.dt, wrap_fn=lambda r: wrap(r, box))
        return init_fn, step_fn, lambda carry: carry

    structure_fn, force_fn = _make_list_force(cfg, impl)
    dt = cfg.dt

    def init_fn(state: ParticleState):
        aux = structure_fn.build(state.position)
        return state.replace(force=force_fn(state.position, aux)), aux

    def step_fn(carry):
        state, aux = carry
        inv_m = 1.0 / state.mass[:, None]
        v_half = state.velocity + 0.5 * dt * state.force * inv_m
        r_new = wrap(state.position + dt * v_half, box)
        aux = structure_fn.maybe_rebuild(r_new, aux)
        f_new = force_fn(r_new, aux)
        v_new = v_half + 0.5 * dt * f_new * inv_m
        return (
            state.replace(position=r_new, velocity=v_new, force=f_new, time=state.time + dt),
            aux,
        )

    return init_fn, step_fn, lambda carry: carry[0]


def _make_list_force(cfg: MDConfig, impl: str):
    """Build the (spatial-structure fn, force fn) pair for list-based paths."""
    if impl == "neighbor":
        from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.neighbor_list import (
            make_lj_force_neighbor,
            make_neighbor_fn,
        )

        nf = make_neighbor_fn(
            cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim,
            skin=resolve_skin(cfg, impl), rho=cfg.rho,
        )
        return nf, make_lj_force_neighbor(nf, sigma=cfg.sigma, epsilon=cfg.epsilon)

    from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
        make_cell_grid_fn,
        make_lj_force_cell_dense,
    )

    gf = make_cell_grid_fn(
        cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim,
        skin=resolve_skin(cfg, impl), rho=cfg.rho,
    )
    return gf, make_lj_force_cell_dense(gf, sigma=cfg.sigma, epsilon=cfg.epsilon)


def make_energy_fn(cfg: MDConfig):
    """Potential-energy observable matched to the force implementation (list
    paths reuse the carried spatial structure — O(N*K) / cell-dense)."""
    impl = resolve_impl(cfg)
    if impl not in ("neighbor", "cell"):
        lj = make_potential(cfg)
        return lambda carry: lj.energy(carry.position)

    _, list_force = _make_list_force(cfg, impl)

    def energy(carry):
        state, aux = carry
        return list_force.energy(state.position, aux)

    return energy


def _carry_overflow(carry) -> jax.Array:
    """Spatial-structure overflow flag of a build_step carry (False for the
    dense paths, which have no capacity/skin structure to overflow)."""
    if isinstance(carry, tuple):
        return carry[1].overflow
    return jnp.zeros((), bool)


@partial(jax.jit, static_argnums=(0,))
def equilibrate(cfg: MDConfig, state: ParticleState):
    """Device-fused equilibration (reference: molecular_dynamics...:77-83).

    Returns ``(state, overflow)`` — the capacity/skin overflow flag of the
    underlying spatial structure is carried out, never dropped (silent
    failure is banned; see CLAUDE.md invariants)."""
    if resolve_impl(cfg) == "grid":
        md = _make_grid_md(cfg)
        k, gate = _grid_inner_steps(cfg, md)
        thermo = _grid_thermostat(cfg)
        gs = md.prepare(
            md.init(state.position, state.velocity, seed=_grid_seed(cfg))
        )
        n_chunks, rem = divmod(cfg.eq_steps, k)
        if n_chunks:
            # cond-free nested-while driver (no per-chunk lax.cond)
            gs = md.make_production_run(
                n_chunks * k, k, gate_frac=gate, thermostat=thermo
            )(gs)
        if rem:
            gs = md.make_chunk_step(rem, gate_frac=gate, thermostat=thermo)(gs)
        return (
            state.replace(
                position=md.positions(gs),
                velocity=md.velocities(gs),
                time=state.time + gs.time,
            ),
            gs.overflow,
        )
    init_fn, step_fn, get_state = build_step(cfg)
    carry = run_steps(step_fn, init_fn(state), cfg.eq_steps)
    return get_state(carry), _carry_overflow(carry)


@partial(jax.jit, static_argnums=(0, 2))
def production(cfg: MDConfig, state: ParticleState, cadence: Optional[int] = None):
    """Device-fused production with trajectory sampling
    (reference: molecular_dynamics...:85-106). Additionally samples kinetic /
    potential energy for the drift regression the reference never had.

    ``cadence``: fixed rebuild cadence for the 3D grid engine's NVE
    path (make_production_run_fixed — zero gate machinery). Callers obtain it
    from ``auto_cadence`` on the MEASURED equilibrated temperature
    (:func:`run` does); ``None`` keeps the displacement-gated driver.
    Safety demotes to the window's skin/2 violation flag — loud, never
    silent.

    Returns ``(final_state, (r_history, ke_history, pe_history), overflow)``.
    """
    if cfg.prod_steps and cfg.sample_every > cfg.prod_steps:
        raise ValueError(
            f"sample_every ({cfg.sample_every}) > prod_steps ({cfg.prod_steps}): "
            "production would emit zero samples (empty histories, NaN drift). "
            "Lower sample_every or raise prod_steps."
        )
    if resolve_impl(cfg) == "grid":
        md = _make_grid_md(cfg)
        k, gate = _grid_inner_steps(cfg, md)
        thermo = _grid_thermostat(cfg)
        gs = md.prepare(
            md.init(state.position, state.velocity, seed=_grid_seed(cfg))
        )
        use_fixed = (
            cadence is not None
            and thermo is None
            and hasattr(md, "make_production_run_fixed")
        )
        if use_fixed:
            prod_block = md.make_production_run_fixed(cfg.sample_every, cadence)
        else:
            # cond-free gated production driver
            prod_block = md.make_production_run(
                cfg.sample_every, k, gate_frac=gate, thermostat=thermo
            )

        def sample_block(g, _):
            g = prod_block(g)
            return g, (md.positions(g), md.kinetic_energy(g), md.potential_energy(g))

        n_samples = cfg.prod_steps // cfg.sample_every
        gs, (r_hist, ke_hist, pe_hist) = jax.lax.scan(
            sample_block, gs, length=n_samples
        )
        rem = cfg.prod_steps - n_samples * cfg.sample_every
        if rem and use_fixed:
            gs = md.make_production_run_fixed(rem, cadence)(gs)
        elif rem:
            # the tail can exceed the window budget k — run it in k-sized
            # windows (a window longer than k would erode the skin margin)
            n2, r2 = divmod(rem, k)
            if n2:
                gs = md.make_production_run(
                    n2 * k, k, gate_frac=gate, thermostat=thermo
                )(gs)
            if r2:
                gs = md.make_chunk_step(r2, gate_frac=gate, thermostat=thermo)(gs)
        final = state.replace(
            position=md.positions(gs),
            velocity=md.velocities(gs),
            time=state.time + gs.time,
        )
        return final, (r_hist, ke_hist, pe_hist), gs.overflow

    init_fn, step_fn, get_state = build_step(cfg)
    energy_fn = make_energy_fn(cfg)

    def observe(carry):
        s = get_state(carry)
        return s.position, kinetic_energy(s), energy_fn(carry)

    final, (r_hist, ke_hist, pe_hist) = run_trajectory(
        step_fn, init_fn(state), cfg.prod_steps, cfg.sample_every, observe_fn=observe
    )
    return get_state(final), (r_hist, ke_hist, pe_hist), _carry_overflow(final)


def rdf(cfg: MDConfig, r_history: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """g(r) with the reference's binning defaults (molecular_dynamics...:156-162)."""
    r_max = cfg.box_size / 2.0
    nbins = int(r_max / cfg.rdf_dr)
    return radial_distribution(r_history, cfg.box_size, nbins, r_max, dim=cfg.dim)


@dataclass
class MDResult:
    state: ParticleState
    r_history: jax.Array
    ke_history: jax.Array
    pe_history: jax.Array
    rdf_r: jax.Array
    rdf_g: jax.Array
    time_eq_s: float
    time_prod_s: float
    time_rdf_s: float
    # one-time XLA compile (or persistent-cache executable load) of the two
    # phase programs — paid before the physics timers start (see run())
    time_compile_s: float = 0.0
    particle_steps_per_sec: float = 0.0
    # Capacity/skin overflow from the spatial structure (grid/cell/neighbor):
    # True means some structural invariant was violated mid-run and the
    # physics after that point is suspect. Never silently dropped.
    overflow: bool = False
    rdf_subset: int = 0  # >0: g(r) was estimated from this many particles
    # Instantaneous virial pressure of the final state (grid engine only;
    # NaN elsewhere). The reference computes no pressure at all.
    pressure: float = float("nan")
    # geometry/timing of the production samples (for transport analysis)
    box: float = 0.0
    dt_sample: float = 0.0

    @property
    def energy_drift(self) -> float:
        """Max relative drift of total energy over production samples."""
        e = self.ke_history + self.pe_history
        if e.shape[0] == 0:
            return float("nan")
        e0 = e[0]
        return float(jnp.max(jnp.abs(e - e0) / jnp.abs(e0)))

    def transport(self):
        """``(msd_curve, D, fit_residual_rms)`` from the production samples:
        sliding-origin MSD + Einstein-relation self-diffusion coefficient
        (observables/msd.py). Needs >= 4 samples; the reference computes no
        transport coefficients at all."""
        from jax_tpus_benchmark_physics_simulation_tpu.ops.observables.msd import (
            diffusion_coefficient,
            mean_squared_displacement,
        )

        if self.r_history.shape[0] < 4 or not self.box:
            return None, float("nan"), float("nan")
        msd = mean_squared_displacement(self.r_history, self.box)
        d_coef, resid = diffusion_coefficient(
            msd, self.dt_sample, self.r_history.shape[-1]
        )
        return msd, float(d_coef), float(resid)


def run(
    cfg: Optional[MDConfig] = None,
    key: Optional[jax.Array] = None,
    ckpt_dir: Optional[str] = None,
    progress=None,
) -> MDResult:
    """Full timed pipeline: equilibrate -> production -> g(r), matching the
    reference's three-phase timing (molecular_dynamics...:138-165).

    With ``ckpt_dir``, the equilibrated state is checkpointed (orbax) and
    reused on re-runs — the resumability the reference lacks (SURVEY.md §5).
    ``progress``: optional report.console.progress() handle — each phase gets
    a live spinner (the phases are single fused device programs, so there is
    nothing finer to tick; parity with the reference's per-phase spinners).
    """
    cfg = cfg or MDConfig()
    if cfg.thermostat not in ("none", None) and resolve_impl(cfg) != "grid":
        raise ValueError(
            f"thermostat={cfg.thermostat!r} is implemented for the grid "
            f"engine only (resolved force_impl: {resolve_impl(cfg)!r}); "
            "use --force-impl grid / a cutoff so the grid path dispatches"
        )
    state = init_state(cfg, key)

    def phase(desc):
        return progress.add_task(desc, total=None) if progress is not None else None

    def phase_done(task):
        if progress is not None:
            progress.update(task, total=1, completed=1)

    # AOT-compile AND warm each phase program OUTSIDE the physics timers:
    # part of an executable's load is paid lazily at its FIRST execution,
    # so each executable is run once on a throwaway input and discarded
    # before its timer starts; the compile+load+warm-up cost is real and
    # reported separately (MDResult.time_compile_s).
    state_eq = None
    overflow_eq = False
    if ckpt_dir is not None:
        from jax_tpus_benchmark_physics_simulation_tpu.ckpt import (
            latest_step,
            restore_checkpoint,
        )

        if latest_step(ckpt_dir) is not None:
            state_eq = restore_checkpoint(ckpt_dir, state)

    time_compile = 0.0
    if state_eq is None:
        t0 = time.perf_counter()
        task = phase("compile + warm (equilibration)")
        eq_exe = equilibrate.lower(cfg, state).compile()
        jax.block_until_ready(eq_exe(state))  # absorb lazy executable load
        time_compile += time.perf_counter() - t0
        phase_done(task)

        t0 = time.perf_counter()
        task = phase(f"equilibration ({cfg.eq_steps:,} steps)")
        state_eq, overflow_eq = jax.block_until_ready(eq_exe(state))
        overflow_eq = bool(overflow_eq)
        if ckpt_dir is not None:
            from jax_tpus_benchmark_physics_simulation_tpu.ckpt import save_checkpoint

            save_checkpoint(ckpt_dir, cfg.eq_steps, state_eq)
        time_eq = time.perf_counter() - t0
        phase_done(task)
    else:
        time_eq = 0.0

    # Rebuild cadence for the 3D grid NVE fast path, from the MEASURED
    # equilibrated temperature (auto_cadence's drift-rate fit is in kT; the
    # config's kt is a target the NVE melt need not land on exactly).
    cadence = None
    if cfg.dim == 3 and cfg.thermostat in ("none", None) and resolve_impl(cfg) == "grid":
        import numpy as _np

        v = _np.asarray(state_eq.velocity)
        kt_eq = float(_np.mean(v * v))  # mean over N*dim of v^2 = kT/m
        md_c = _make_grid_md(cfg)
        if hasattr(md_c, "auto_cadence"):
            cadence = max(
                1,
                min(md_c.auto_cadence(kt_eq, cfg.prod_steps), cfg.sample_every),
            )

    t0 = time.perf_counter()
    task = phase("compile + warm (production)")
    prod_exe = production.lower(cfg, state_eq, cadence).compile()
    jax.block_until_ready(prod_exe(state_eq))  # absorb lazy executable load
    time_compile += time.perf_counter() - t0
    phase_done(task)

    t0 = time.perf_counter()
    task = phase(f"production ({cfg.prod_steps:,} steps)")
    final, (r_hist, ke_hist, pe_hist), overflow_prod = jax.block_until_ready(
        prod_exe(state_eq)
    )
    time_prod = time.perf_counter() - t0
    phase_done(task)
    overflow = overflow_eq or bool(overflow_prod)
    if overflow:
        import warnings

        warnings.warn(
            "MD spatial structure reported a capacity/skin overflow: some "
            "pair interactions may have been missed. Results are suspect — "
            "increase skin/capacity or reduce dt.",
            stacklevel=2,
        )

    t0 = time.perf_counter()
    task = phase(f"g(r) ({int(r_hist.shape[0])} snapshots)")
    rdf_r, rdf_g = jax.block_until_ready(rdf(cfg, r_hist))
    time_rdf = time.perf_counter() - t0
    phase_done(task)

    pressure = float("nan")
    if resolve_impl(cfg) == "grid":
        # one sampling-kernel pass on the final state (virial + KE)
        md = _make_grid_md(cfg)
        gs = md.prepare(md.init(final.position, final.velocity))
        pressure = float(md.pressure(gs))

    res = MDResult(
        state=final,
        r_history=r_hist,
        ke_history=ke_hist,
        pe_history=pe_hist,
        rdf_r=rdf_r,
        rdf_g=rdf_g,
        time_eq_s=time_eq,
        time_prod_s=time_prod,
        time_rdf_s=time_rdf,
        time_compile_s=time_compile,
        particle_steps_per_sec=cfg.n
        * (cfg.eq_steps + cfg.prod_steps)
        / max(time_eq + time_prod, 1e-12),
        overflow=overflow,
        rdf_subset=_RDF_MAX_PARTICLES if cfg.n > _RDF_MAX_PARTICLES else 0,
        pressure=pressure,
        box=cfg.box_size,
        dt_sample=cfg.dt * cfg.sample_every,
    )
    return res

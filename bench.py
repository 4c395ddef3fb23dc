#!/usr/bin/env python
"""Driver benchmark: one JSON line on stdout.

Headline metric: LJ-MD particle-steps/sec at N=100k (cutoff 2.5, rho 0.8,
kT 1.0, dt 1e-3) on the available device, using the grid-resident MD
engine.

vs_baseline: measured speedup over a faithful re-implementation of the
reference's MD method — full O(N^2) pair matrix, forces via autodiff, two
force evaluations per Verlet step, no cutoff/neighbor structure
(molecular_dynamics_jax_single-host_workload.py:50-75) — at N=16384, the
largest size where the reference method fits comfortably in HBM (its (N,N,2)
displacement tensor at N=100k would need ~240 GB and cannot run at the
headline size at all). Diagnostics go to stderr; stdout carries exactly one
JSON line.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from jax_tpus_benchmark_physics_simulation_tpu.utils.cache import (
    enable_compilation_cache,
)


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def lattice(n, box, key, kt=1.0):
    per = int(np.ceil(np.sqrt(n)))
    sp = box / per
    g = jnp.arange(per, dtype=jnp.float32) * sp + 0.5 * sp
    mesh = jnp.stack(jnp.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)[:n]
    pos = jnp.mod(mesh + 0.05 * jax.random.normal(key, mesh.shape), box)
    vel = np.sqrt(kt) * jax.random.normal(jax.random.fold_in(key, 1), (n, 2))
    return pos, vel


def bench_grid_md(n, steps=400, repeats=3):
    from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
        make_cell_grid_fn,
    )
    from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD

    rho, cutoff, dt = 0.8, 2.5, 1e-3
    box = float(np.sqrt(n / rho))
    gf = make_cell_grid_fn(box, cutoff, n, dim=2)
    # compensated: the production configuration (f32 secular drift ~1e-6
    # over 1M steps instead of 7e-3); plain mode is ~25% faster if you only
    # care about short runs.
    md = GridMD(gf, dt=dt, compensated=True)
    pos, vel = lattice(n, box, jax.random.PRNGKey(0))
    gs = md.init(pos, vel)

    k, gate = md.auto_chunk_params(kt=1.0)
    n_chunks = max(1, steps // k)
    # cond-free nested-while driver (no per-chunk lax.cond)
    prod = md.make_production_run(n_chunks * k, k, gate_frac=gate)

    @jax.jit
    def run(s):
        s = prod(s)
        return s, md.kinetic_energy(s)

    # Equilibration under a rescaling protocol: the lattice melt self-heats, so the melt
    # windows are SIZED for the hot transient (auto_chunk_params at an
    # elevated kT -> shorter windows, tighter gate) and velocities are
    # rescaled back to kT=1 between bursts. The skin-violation flag is
    # never cleared — it must stay False from init through the timed runs
    # (it is asserted below on the final state).
    k_eq, gate_eq = md.auto_chunk_params(kt=4.0)
    chunk_eq = md.make_chunk_step(k_eq, gate_frac=gate_eq)

    @jax.jit
    def equil_burst(s):
        s = jax.lax.fori_loop(0, max(1, 200 // k_eq), lambda i, t: chunk_eq(t), s)
        return s, md.kinetic_energy(s)

    for _ in range(4):
        gs, ke = equil_burst(gs)
        scale = float(np.sqrt(1.0 * n / float(ke)))  # kT = KE/(dof/2), dof=2N
        comp = (
            dict(cvx=jnp.zeros_like(gs.cvx), cvy=jnp.zeros_like(gs.cvy))
            if gs.cvx is not None
            else {}
        )
        gs = gs.replace(vxg=gs.vxg * scale, vyg=gs.vyg * scale, **comp)
    gs, ke = jax.block_until_ready(run(gs))  # compile + settle at kT~1
    assert not bool(gs.overflow), "violation during equilibration (melt windows)"
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        gs, ke = jax.block_until_ready(run(gs))
        best = min(best, time.perf_counter() - t0)
    assert not bool(gs.overflow), "skin/capacity violation during benchmark"
    n_steps = n_chunks * k
    return n * n_steps / best, best / n_steps


def bench_reference_method(n, steps=20, repeats=3):
    """The reference's MD step, re-expressed faithfully: dense O(N^2) LJ
    energy, force = grad(-E), TWO force evaluations per step, no cutoff
    (molecular_dynamics...:50-75)."""
    rho, dt = 0.8, 1e-3
    box = float(np.sqrt(n / rho))
    sigma = epsilon = 1.0

    def total_energy(r):
        dr = r[:, None, :] - r[None, :, :]
        dr = dr - box * jnp.round(dr / box)
        r2 = jnp.sum(dr**2, axis=-1)
        mask = ~jnp.eye(n, dtype=bool)
        r2s = jnp.where(mask, r2, 1.0)
        s6 = (sigma**2 / r2s) ** 3
        pair = 4.0 * epsilon * (s6**2 - s6)
        return 0.5 * jnp.sum(jnp.where(mask, pair, 0.0))

    force = jax.grad(lambda r: -total_energy(r))

    def step(state):
        r, v = state
        f = force(r)
        v_half = v + 0.5 * f * dt
        r = jnp.mod(r + v_half * dt, box)
        f_new = force(r)
        v = v_half + 0.5 * f_new * dt
        return (r, v)

    @jax.jit
    def run(state):
        state = jax.lax.fori_loop(0, steps, lambda i, s: step(s), state)
        return state, jnp.sum(state[1] ** 2)

    pos, vel = lattice(n, box, jax.random.PRNGKey(0))
    state = jax.block_until_ready(run((pos, vel)))[0]
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        state, ke = jax.block_until_ready(run(state))
        best = min(best, time.perf_counter() - t0)
    return n * steps / best, best / steps


def main():
    log(f"compile cache: {enable_compilation_cache()}")
    log(f"backend: {jax.default_backend()}, devices: {jax.devices()}")

    n_head = 100_000
    psps, ms = bench_grid_md(n_head, steps=2400)
    log(f"grid MD N={n_head}: {ms * 1e3:.3f} ms/step -> {psps / 1e6:.1f}M particle-steps/s")

    n_cmp = 16_384
    ours_cmp, _ = bench_grid_md(n_cmp, steps=8000)
    ref_cmp, ref_ms = bench_reference_method(n_cmp)
    log(
        f"comparison N={n_cmp}: ours {ours_cmp / 1e6:.1f}M psps vs "
        f"reference-method {ref_cmp / 1e6:.2f}M psps ({ref_ms * 1e3:.2f} ms/step)"
    )
    vs_baseline = ours_cmp / ref_cmp

    print(
        json.dumps(
            {
                "metric": "lj_md_particle_steps_per_sec_n100k",
                "value": psps,
                "unit": "particle-steps/s",
                "vs_baseline": vs_baseline,
            }
        )
    )


if __name__ == "__main__":
    main()

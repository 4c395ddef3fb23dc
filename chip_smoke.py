#!/usr/bin/env python
"""Smoke test of the system on an NVIDIA GPU: the quickest proof that the
main path starts, runs its compiled kernels and gets the physics right.

    python chip_smoke.py           # one GPU: phases 0-3
    python chip_smoke.py --four    # four GPUs: the sharded MD engines only

Run it from the repository root. It is one process that opens the card(s)
once, runs its phases in order and exits non-zero on the first failure (a
failed check raises; nothing is caught and passed over). Without a GPU it
exits 1 and prints no result line.

Phases (one GPU):

0. device: the card's ``name, power.limit`` (nvidia-smi), JAX version,
   ``XLA_FLAGS`` and the compile-cache directory;
1. force kernels at real widths (2D and 3D N=100k grids built from a
   jittered lattice): the chosen implementation against the plain version
   on the same layout (forces, energy, virial) and both against the dense
   LJ oracle for 4,096 particles against all N; then proof that the chosen
   implementation is what the production window compiles to;
2. the LJ-MD main path through ``lj_fluid.run`` (what ``jtps md`` calls):
   2D and 3D N=100k NVE, 3D N=100k Langevin, 3D N=1M NVE, and 3D N=100k
   once more through ``cli.main(["md", ...])``;
3. the other workloads through ``cli.main``: nbody, em3, vmc, bench.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

LATTICE_JITTER = 0.05  # sigma units; see _md_state
N_MAIN = 100_000  # particles of the 100k configurations
N_LARGE = 1_000_000  # particles of the 1M configurations
BENCH_ARGV = ["bench", "-mxs", "2048", "-m", "20", "--no-plot"]
VMC_ARGV = ["vmc", "--dim", "3", "--no-gif", "--no-plot"]


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# -- helpers ------------------------------------------------------------------

def _md_state(cfg, jitter: float):
    """Lattice start (``lj_fluid.init_state``) with a seeded displacement of
    ``jitter`` sigma. On an exact lattice the forces cancel by symmetry, so
    max|F| is a small difference of large pair terms and no sound scale for
    a relative tolerance; a small jitter gives every particle a real net
    force."""
    import jax
    import jax.numpy as jnp

    from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid

    st = lj_fluid.init_state(cfg)
    if not jitter:
        return st.position, st.velocity
    noise = jax.random.normal(jax.random.PRNGKey(cfg.seed + 1), st.position.shape)
    return jnp.mod(st.position + jitter * noise, cfg.box_size), st.velocity


def _per_particle(md, grids, pid):
    """Grid-layout per-slot values -> (N, len(grids)) in particle order."""
    import jax.numpy as jnp

    pid = pid.reshape(-1)
    tgt = jnp.where(pid >= 0, pid, md.n)
    out = jnp.zeros((md.n + 1, len(grids)), grids[0].dtype)
    for c, g in enumerate(grids):
        out = out.at[tgt, c].set(g.reshape(-1), mode="drop")
    return out[: md.n]


def _coords(gs, dim):
    return [gs.xg, gs.yg] + ([gs.zg] if dim == 3 else [])


def _forces(gs, dim):
    return [gs.fxg, gs.fyg] + ([gs.fzg] if dim == 3 else [])


def _pallas_calls(jaxpr):
    """Every pallas_call equation in a jaxpr, nested ones included."""
    from jax.extend.core import ClosedJaxpr, Jaxpr

    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "pallas_call":
                found.append(eqn)
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else [v]:
                    if isinstance(sub, ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, Jaxpr):
                        walk(sub)

    walk(jaxpr.jaxpr if hasattr(jaxpr, "jaxpr") else jaxpr)
    return found


TRITON_TARGET = "__gpu$xla.gpu.triton"


def _cutoff_force(cfg) -> float:
    """|F| of one pair at the cutoff. The potential is energy-shifted, not
    force-shifted, so the force jumps by this much at r_c."""
    sr6 = (cfg.sigma / cfg.cutoff) ** 6
    return abs(24.0 * cfg.epsilon * (2.0 * sr6 * sr6 - sr6) / cfg.cutoff)


def _compare_forces(tag, got, want, cfg, n_particles):
    """Forces of two implementations of the same pair sum: max|dF| <=
    1e-5*max|F| (f32 summation order). Beyond that only pairs sitting on
    the cutoff may differ: r2 rounded in another last bit (XLA's fusion and
    the Triton kernel contract multiply-adds differently) can put one on
    the other side, which moves its two particles by at most the cutoff
    force. So: every particle within 1e-5*max|F| + F(r_c), and only a few
    (at most 1e-4 * N) beyond 1e-5*max|F|. Returns the relative error."""
    import jax.numpy as jnp

    fmax = max(float(jnp.max(jnp.abs(f))) for f in want)
    diff = jnp.max(jnp.stack([jnp.abs(a - b) for a, b in zip(got, want)]), axis=0)
    tol = 1e-5 * fmax
    worst = float(jnp.max(diff))
    n_over = int(jnp.sum(diff > tol))
    log(
        f"{tag}: max|dF|/max|F| = {worst / fmax:.3e}; slots beyond 1e-5*max|F|: "
        f"{n_over} (cutoff-force allowance {_cutoff_force(cfg):.4f}, max|F| {fmax:.3f})"
    )
    check(worst <= tol + _cutoff_force(cfg), f"{tag}: forces differ")
    check(n_over <= max(4, 1e-4 * n_particles), f"{tag}: too many slots differ")
    return worst / fmax


# -- phase 1 ------------------------------------------------------------------

def phase_kernels(card: str) -> None:
    import jax
    import jax.numpy as jnp

    from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid
    from jax_tpus_benchmark_physics_simulation_tpu.ops.forces.lennard_jones import (
        LennardJones,
    )
    from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_force import (
        choose_impl,
        make_grid_force,
    )

    impl = choose_impl()
    log(f"[1] force implementation chosen for this platform: {impl}")
    for dim in (2, 3):
        cfg = override(MDConfig(), n=N_MAIN, dim=dim, cutoff=2.5, init="lattice")
        md = lj_fluid._make_grid_md(cfg)
        pos, vel = _md_state(cfg, LATTICE_JITTER)
        gs = jax.jit(md.init)(pos, vel)
        check(not bool(gs.overflow), f"{dim}D grid init overflowed")
        mo = gs.max_occ if dim == 3 else None
        coords = _coords(gs, dim)
        log(
            f"[1] {dim}D N={md.n}: grid {md.grid_shape} (cells per side "
            f"{md.cps}, capacity {md.cap}, skin {md.skin:.4f}"
            + (f", max occupancy {int(mo)})" if mo is not None else ")")
        )
        check(md.force_kernel.impl == impl, "engine force is not the chosen one")

        plain_f = make_grid_force(md.grid_fn, impl="plain")
        plain_e = make_grid_force(md.grid_fn, impl="plain", with_energy=True)
        run = lambda f: jax.block_until_ready(
            jax.jit(lambda *c: f(*c, max_occ=mo))(*coords)
        )
        f_k = run(md.force_kernel)
        e_k = run(md.energy_kernel)
        with jax.default_matmul_precision("highest"):
            f_p = run(plain_f)
            e_p = run(plain_e)
        if impl != "plain":
            tag = f"[1] {dim}D {impl} vs plain"
            _compare_forces(tag, f_k[:dim], f_p[:dim], cfg, md.n)
            _compare_forces(tag + " (energy pass)", e_k[:dim], f_p[:dim], cfg, md.n)
            ek, ep = float(jnp.sum(e_k[dim])), float(jnp.sum(e_p[dim]))
            wk, wp = float(jnp.sum(e_k[dim + 1])), float(jnp.sum(e_p[dim + 1]))
            rel_e, rel_w = abs(ek - ep) / abs(ep), abs(wk - wp) / abs(wp)
            log(f"{tag}: |dE|/|E| = {rel_e:.3e}, |dW|/|W| = {rel_w:.3e} (E {0.5 * ep:.3f})")
            # the energy is shifted to 0 at r_c: cutoff pairs do not move it
            check(rel_e <= 1e-6 and rel_w <= 1e-6, f"{dim}D energy/virial differ")
        else:
            log("[1] only the plain version exists here: kernel comparison skipped")

        # independent dense oracle: 4,096 particles against all N, blocked
        idx = jax.random.choice(
            jax.random.PRNGKey(7), md.n, (4096,), replace=False
        )
        p_now = md.positions(gs)
        with jax.default_matmul_precision("highest"):
            lj = LennardJones(box=cfg.box_size, cutoff=cfg.cutoff)
            f_ref = jax.block_until_ready(jax.jit(lj.force_on)(p_now, idx))
        ref_max = float(jnp.max(jnp.abs(f_ref)))
        for name, f in ((impl, f_k), ("plain", f_p))[: 1 + (impl != "plain")]:
            f_sel = _per_particle(md, list(f[:dim]), gs.pid)[idx]
            err = float(jnp.max(jnp.abs(f_sel - f_ref)))
            log(f"[1] {dim}D {name} vs dense oracle (4096 x {md.n}): max|dF|/max|F| = {err / ref_max:.3e}")
            check(err <= 1e-4 * ref_max, f"{dim}D {name} disagrees with the dense oracle")

        # the chosen implementation is what a production window compiles to
        k, gate = lj_fluid._grid_inner_steps(cfg, md)
        window = md.make_production_run(2 * k, k, gate_frac=gate)
        calls = _pallas_calls(jax.make_jaxpr(window)(gs))
        hlo = jax.jit(window).lower(gs).as_text()
        check(
            all(not eqn.params.get("interpret", False) for eqn in calls),
            "a Pallas call runs in interpret mode",
        )
        if impl == "triton":
            check(calls and TRITON_TARGET in hlo, "no Triton kernel in the production window")
        else:
            check(not calls, "unexpected Pallas call in the plain production window")
        log(
            f"[1] {dim}D production window: {len(calls)} Pallas call(s), none "
            f"interpreted; Triton custom call in HLO: {TRITON_TARGET in hlo}  [{card}]"
        )


# -- phase 2 ------------------------------------------------------------------

def _check_md(tag: str, res, cfg, card: str, nve: bool) -> None:
    drift = res.energy_drift
    prod_psps = cfg.n * cfg.prod_steps / res.time_prod_s
    log(
        f"[2] {tag}: compile {res.time_compile_s:.3f} s, eq {res.time_eq_s:.4f} s, "
        f"prod {res.time_prod_s:.4f} s, production {prod_psps:.6e} particle-steps/s, "
        f"drift {drift:.3e}, P* {res.pressure:.5f}, overflow {res.overflow}  [{card}]"
    )
    check(not res.overflow, f"{tag}: overflow flagged")
    if nve:
        check(math.isfinite(drift) and drift < 1e-4, f"{tag}: NVE energy drift {drift}")
    check(math.isfinite(res.pressure), f"{tag}: virial pressure not finite")


def phase_main_path(card: str, tmp: str) -> None:
    from jax_tpus_benchmark_physics_simulation_tpu import cli
    from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid

    runs = [
        (f"2D N={N_MAIN} NVE", dict(n=N_MAIN, dim=2, eq_steps=2000, prod_steps=2000)),
        (f"3D N={N_MAIN} NVE", dict(n=N_MAIN, dim=3, eq_steps=2000, prod_steps=2000)),
        (f"3D N={N_MAIN} Langevin", dict(n=N_MAIN, dim=3, eq_steps=1000,
                                         prod_steps=1000, thermostat="langevin")),
        (f"3D N={N_LARGE} NVE", dict(n=N_LARGE, dim=3, eq_steps=500, prod_steps=500)),
    ]
    for tag, kw in runs:
        cfg = override(MDConfig(), cutoff=2.5, init="lattice", sample_every=100, **kw)
        check(lj_fluid.resolve_impl(cfg) == "grid", f"{tag}: not on the grid engine")
        res = lj_fluid.run(cfg)
        _check_md(tag, res, cfg, card, nve=cfg.thermostat == "none")

    manifest = os.path.join(tmp, "md.json")
    t0 = time.perf_counter()
    rc = cli.main([
        "md", "--dim", "3", "--N", str(N_MAIN), "--cutoff", "2.5", "--init", "lattice",
        "--eq_steps", "2000", "--prod_steps", "2000", "--sample_every", "100",
        "--output", "", "--manifest", manifest,
    ])
    wall = time.perf_counter() - t0
    check(rc == 0, f"jtps md --dim 3 exited {rc}")
    res = json.load(open(manifest))["results"]
    log(
        f"[2] jtps md --dim 3 --N {N_MAIN}: exit {rc}, wall {wall:.2f} s, "
        f"eq {res['time_eq_s']:.4f} s, prod {res['time_prod_s']:.4f} s, "
        f"drift {res['energy_drift']:.3e}, P* {res['pressure']:.5f}  [{card}]"
    )
    check(res["energy_drift"] < 1e-4 and math.isfinite(res["pressure"]), "CLI md physics")


# -- phase 3 ------------------------------------------------------------------

def phase_workloads(card: str, tmp: str) -> None:
    from jax_tpus_benchmark_physics_simulation_tpu import cli

    def run(name, argv):
        manifest = os.path.join(tmp, f"{name}.json")
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--manifest", manifest])
        wall = time.perf_counter() - t0
        check(rc == 0, f"jtps {name} exited {rc}")
        return json.load(open(manifest))["results"], wall

    res, wall = run("nbody", ["nbody", "--no-media"])
    log(f"[3] nbody: wall {wall:.2f} s, lyapunov {res['lyapunov']}, trajectory finite {res['trajectory_finite']}  [{card}]")
    check(res["trajectory_finite"] and math.isfinite(res["lyapunov"]), "nbody results not finite")

    res, wall = run("em3", ["em3", "--no-media"])
    log(f"[3] em3: wall {wall:.2f} s, trajectory finite {res['trajectory_finite']}  [{card}]")
    check(res["trajectory_finite"], "em3 trajectory not finite")

    res, wall = run("vmc", VMC_ARGV)
    log(
        f"[3] vmc 3D: wall {wall:.2f} s, E_vmc {res['vmc_energy']:.6f} "
        f"(exact {res['exact_energy']}), E_dmc {res['dmc_energy']:.6f}  [{card}]"
    )
    check(abs(res["vmc_energy"] - 1.5) < 0.01, "VMC energy off the exact 1.5")

    res, wall = run("bench", BENCH_ARGV)
    for row in res["results"]:
        log(
            f"[3] bench {row['test']:9s} cores={row['cores']} "
            f"precision={row.get('precision')} avg_ms={row.get('avg_ms')} "
            f"tflops={row.get('tflops')} GB/s={row.get('bandwidth_gbs')}  [{card}]"
        )
    check(res["results"] and not any("error" in r for r in res["results"]), "bench error rows")


# -- four cards ---------------------------------------------------------------

def phase_four(card: str) -> None:
    """The sharded engines lj_fluid picks on four cards, against the
    one-card engine on the same state in the same process."""
    import jax
    import jax.numpy as jnp

    from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid
    from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD
    from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3
    from jax_tpus_benchmark_physics_simulation_tpu.parallel.grid_md3_sharded import (
        ShardedGridMD3,
    )
    from jax_tpus_benchmark_physics_simulation_tpu.parallel.grid_md_sharded import (
        ShardedGridMD,
    )

    n_dev = jax.device_count()
    check(n_dev == 4, f"--four needs 4 devices, found {n_dev}")
    for dim in (3, 2):
        cfg = override(MDConfig(), n=N_LARGE, dim=dim, cutoff=2.5, init="lattice")
        md = lj_fluid._make_grid_md(cfg)
        cls = ShardedGridMD3 if dim == 3 else ShardedGridMD
        check(isinstance(md, cls), f"{dim}D N=1M: lj_fluid did not pick {cls.__name__}")
        one = (GridMD3 if dim == 3 else GridMD)(
            md.grid_fn, sigma=cfg.sigma, epsilon=cfg.epsilon, dt=cfg.dt,
            compensated=cfg.compensated,
        )
        pos, vel = _md_state(cfg, LATTICE_JITTER)
        gs1 = jax.block_until_ready(jax.jit(one.init)(pos, vel))
        gs4 = md.prepare(gs1)

        def spread(s):
            return all(
                len(leaf.sharding.device_set) == n_dev
                for leaf in jax.tree.leaves(s)
            )

        check(spread(gs4), f"{dim}D: a state array is not on all {n_dev} cards")
        f4 = jax.block_until_ready(md.force_once(gs4))
        log(f"[4] {dim}D N={md.n} grid {md.grid_shape} over {md.n_shards} cards")
        _compare_forces(
            f"[4] {dim}D initial forces, sharded vs one card", f4,
            _forces(gs1, dim), cfg, md.n,
        )

        # dynamics from the plain lattice start that lj_fluid.run uses (the
        # jittered one is a hot start: its close pairs outrun the skin)
        pos0, vel0 = _md_state(cfg, 0.0)
        gs1 = jax.block_until_ready(jax.jit(one.init)(pos0, vel0))
        gs4 = md.prepare(gs1)
        k, gate = lj_fluid._grid_inner_steps(cfg, one)
        n_steps = 200 - 200 % k
        results = {}
        for name, eng, s in (("one card", one, gs1), ("four cards", md, gs4)):
            prod = jax.jit(eng.make_production_run(n_steps, k, gate_frac=gate))
            energy = jax.jit(lambda t, e=eng: e.kinetic_energy(t) + e.potential_energy(t))
            jax.block_until_ready(prod(s))  # compile + warm
            t0 = time.perf_counter()
            out = jax.block_until_ready(prod(s))
            dt_ = time.perf_counter() - t0
            e = float(energy(out))
            check(not bool(out.overflow), f"{dim}D {name}: overflow flagged")
            results[name] = (e, out)
            log(
                f"[4] {dim}D {name}: {n_steps} steps in {dt_:.4f} s "
                f"({md.n * n_steps / dt_:.6e} particle-steps/s), E_total {e:.6f}  [{card}]"
            )
        e1, e4 = results["one card"][0], results["four cards"][0]
        rel = abs(e1 - e4) / abs(e1)
        log(f"[4] {dim}D total energy after {n_steps} steps: |dE|/|E| = {rel:.3e}")
        check(rel <= 1e-5, f"{dim}D sharded energy differs")
        check(spread(results["four cards"][1]), f"{dim}D: sharded output left the mesh")


# -- main ---------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded-engine phase")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"chip_smoke: needs an NVIDIA GPU; JAX found platform "
            f"{devices[0].platform!r} ({devices[0].device_kind})",
            file=sys.stderr,
        )
        return 1
    try:
        from jax_tpus_benchmark_physics_simulation_tpu.bench.sysinfo import (
            gpu_name_and_power_limit,
        )
        from jax_tpus_benchmark_physics_simulation_tpu.utils.cache import (
            enable_compilation_cache,
        )
    except ImportError as exc:
        print(f"chip_smoke: run it from the repository root ({exc})", file=sys.stderr)
        return 1

    card = gpu_name_and_power_limit() or "unknown card"
    log(f"[0] {card}")
    log(f"[0] jax {jax.__version__}, {len(devices)} x {devices[0].device_kind}")
    log(f"[0] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"[0] compile cache: {enable_compilation_cache()}")

    t0 = time.perf_counter()
    if args.four:
        phase_four(card)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            phase_kernels(card)
            phase_main_path(card, tmp)
            phase_workloads(card, tmp)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    log(card)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

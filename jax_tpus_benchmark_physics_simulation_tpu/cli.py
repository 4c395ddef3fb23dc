"""Unified CLI: one entry point with subcommands for the five workloads.

Replaces the reference's four inconsistent argparse blocks + one interactive
prompt script (SURVEY.md §5 "Config/flag system") with:

    jtps bench [...]    tpus_benchmark...:28-39 flags
    jtps md    [...]    molecular_dynamics...:194-215 flags
    jtps nbody [...]    nbody...:29-39 prompts as flags (+ --interactive)
    jtps em3   [...]    three_particles...:9-17 flags
    jtps vmc   [...]    vmc_dmc...:348-360 flags
    jtps devices        utils/jax_devices.py (without import side effects)
    jtps check-deps     utils/check_deps.py (without its NameError bug :103)

Flag names/defaults mirror the reference so users can switch 1:1.
"""

from __future__ import annotations

import argparse
import os
import sys

from jax_tpus_benchmark_physics_simulation_tpu.core import config as cfgs
from jax_tpus_benchmark_physics_simulation_tpu.report import console


def _add_bench(sub):
    p = sub.add_parser("bench", help="op benchmark suite (matmul/FFT/conv/bandwidth)")
    p.add_argument("-w", "--warmup", type=int, default=1,
                   help="untimed executions of the fused timing loop (each = STEPS op iterations)")
    p.add_argument("-r", "--repeats", type=int, default=3,
                   help="timed executions per op (best-of)")
    p.add_argument("-m", "--steps", type=int, default=2500)
    p.add_argument("-mxs", "--matrix_size", type=int, default=4096)
    p.add_argument("-md", "--matrix_depth", type=int, default=6)
    p.add_argument("-c", "--conv_size", type=int, default=128,
                   help="conv input H=W. NOTE: the conv defaults here "
                   "(-c 128 -b 64 --conv_cin 32) are a compute-bound sizing, "
                   "deliberately different from the reference's latency-bound "
                   "-c 64 -b 8 cin=3 (tpus_benchmark...:33-34,141-155); pass "
                   "--reference-conv for the reference's exact sizing")
    p.add_argument("-b", "--batch_size", type=int, default=64)
    p.add_argument("--conv_cin", type=int, default=32)
    p.add_argument("--conv_cout", type=int, default=64)
    p.add_argument("--reference-conv", action="store_true",
                   help="use the reference's conv sizing (-c 64 -b 8 "
                   "--conv_cin 3 --conv_cout 64) instead of the "
                   "compute-bound defaults")
    p.add_argument("--precision", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--max_cores", type=int, default=0)
    p.add_argument("--csv", type=str, default=None)
    p.add_argument("--csv-append", action="store_true",
                   help="append to --csv (no header rewrite) — for sweeps "
                   "split over several runs with --ops")
    p.add_argument("--ops", type=str, default=None,
                   help="comma list of ops to run (2D,3D,Conv,2D_FFT,"
                   "3D_FFT,Bandwidth); default all")
    p.add_argument("--plot", type=str, default="benchmark_results.png")
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--show", action="store_true",
                   help="display figures interactively (reference plt.show() parity)")
    p.add_argument("--manifest", type=str, default="bench_run_manifest.json",
                   help="run-manifest JSON path ('' to disable)")


def _add_md(sub):
    p = sub.add_parser("md", help="Lennard-Jones fluid MD")
    p.add_argument("--N", type=int, default=400)
    p.add_argument("--dim", type=int, default=2, choices=[2, 3],
                   help="2 (reference, molecular_dynamics...:26) or 3 "
                        "(beyond-reference 3D engines)")
    p.add_argument("--rho", type=float, default=0.8)
    p.add_argument("--kT", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--eq_steps", type=int, default=10000)
    p.add_argument("--prod_steps", type=int, default=10000)
    p.add_argument("--sample_every", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output", type=str, default="g_r_plot.png",
                   help="g(r) plot path ('' writes no plot)")
    p.add_argument("--msd-output", type=str, default=None,
                   help="also save the MSD/diffusion plot (no reference analog)")
    p.add_argument("--cutoff", type=float, default=None)
    p.add_argument("--force-impl", type=str, default="auto",
                   choices=["auto", "dense_xla", "neighbor", "cell", "grid"])
    p.add_argument("--init", type=str, default="uniform", choices=["uniform", "lattice"])
    p.add_argument("--thermostat", type=str, default="none",
                   choices=["none", "langevin"],
                   help="NVT via BAOAB Langevin windows at kT (grid engine "
                        "only; the reference is NVE-only)")
    p.add_argument("--gamma", type=float, default=1.0,
                   help="Langevin friction coefficient (1/time)")
    p.add_argument("--ckpt-dir", type=str, default=None)
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the run into DIR")
    p.add_argument("--show", action="store_true",
                   help="display the g(r) figure (reference molecular_dynamics...:190)")
    p.add_argument("--manifest", type=str, default="md_run_manifest.json",
                   help="run-manifest JSON path ('' to disable)")


def _add_mdscale(sub):
    p = sub.add_parser(
        "mdscale",
        help="multi-chip MD scaling sweep (strong/weak) with single-chip "
             "trajectory parity checks",
    )
    p.add_argument("--N", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=2, choices=[2, 3],
                   help="2D (ShardedGridMD) or 3D (ShardedGridMD3) engine")
    p.add_argument("--rho", type=float, default=0.8)
    p.add_argument("--kT", type=float, default=1.0)
    p.add_argument("--dt", type=float, default=1e-3)
    p.add_argument("--cutoff", type=float, default=2.5)
    p.add_argument("--mode", type=str, default="strong", choices=["strong", "weak"])
    p.add_argument("--steps", type=int, default=200,
                   help="timed steps per sweep point")
    p.add_argument("--parity-steps", type=int, default=50,
                   help="steps for the sharded-vs-single parity check (0 = skip)")
    p.add_argument("--devices", type=int, nargs="+", default=None,
                   help="mesh sizes to sweep (default: 1, powers of 2, max)")
    p.add_argument("--virtual", type=int, default=0, metavar="D",
                   help="run on D virtual CPU devices "
                        "(xla_force_host_platform_device_count — validates the "
                        "sharding until >1 real chip is attached)")
    p.add_argument("--csv", type=str, default=None)
    p.add_argument("--manifest", type=str, default="mdscale_run_manifest.json",
                   help="run-manifest JSON path ('' to disable)")


def _add_nbody(sub):
    p = sub.add_parser("nbody", help="N-body BH merger + GW + Lyapunov")
    p.add_argument("--n_bodies", type=int, default=3)
    p.add_argument("--masses", type=float, nargs="+", default=None,
                   help="per-body masses in Msun (default 30 each)")
    p.add_argument("--initial_distance", type=float, default=100.0)
    p.add_argument("--initial_velocity", type=float, default=0.1)
    p.add_argument("--sim_time", type=float, default=200.0)
    p.add_argument("--d_gw", type=float, default=410.0)
    p.add_argument("--num_steps", type=int, default=1000)
    p.add_argument("--no-chaos", action="store_true")
    p.add_argument("--lyapunov", type=str, default="tangent",
                   choices=["tangent", "two_trajectory"])
    p.add_argument("--no-media", action="store_true", help="skip GIF/WAV/plots")
    p.add_argument("--interactive", action="store_true",
                   help="prompt for parameters (reference behavior)")
    p.add_argument("--manifest", type=str, default="nbody_run_manifest.json",
                   help="run-manifest JSON path ('' to disable)")
    p.add_argument("--ckpt-dir", type=str, default=None,
                   help="orbax checkpoint dir: completed trajectories are "
                        "restored on re-run (re-plot without recompute)")


def _add_em3(sub):
    p = sub.add_parser("em3", help="three charged particles, gravity + EM field")
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--n_steps", type=int, default=1000)
    p.add_argument("--G", type=float, default=1.0)
    p.add_argument("--Bz", type=float, default=1.0)
    p.add_argument("--Bk", type=float, default=0.0)
    p.add_argument("--Ex", type=float, default=0.0)
    p.add_argument("--Ey", type=float, default=0.0)
    p.add_argument("--integrator", type=str, default="boris", choices=["boris", "reference"])
    p.add_argument("--no-media", action="store_true")
    p.add_argument("--manifest", type=str, default="em3_run_manifest.json",
                   help="run-manifest JSON path ('' to disable)")


def _add_vmc(sub):
    p = sub.add_parser("vmc", help="VMC + DMC quantum harmonic oscillator")
    p.add_argument("--n_walkers", type=int, default=10000)
    p.add_argument("--n_epochs", type=int, default=3000)
    p.add_argument("--n_equil", type=int, default=100)
    p.add_argument("--step_size", type=float, default=2.0)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--n_dmc", type=int, default=500)
    p.add_argument("--dmc_dt", type=float, default=0.01)
    p.add_argument("--dim", type=int, default=3)
    p.add_argument("--resampler", type=str, default="systematic",
                   choices=["systematic", "multinomial"])
    p.add_argument("--potential", type=str, default="harmonic",
                   choices=["harmonic", "anharmonic"],
                   help="anharmonic: V += lam*sum(x^4), generic autodiff "
                        "local energy + {alpha, beta} trial wavefunction")
    p.add_argument("--lam", type=float, default=0.2,
                   help="quartic coupling (potential=anharmonic)")
    p.add_argument("--no-gif", action="store_true")
    p.add_argument("--no-plot", action="store_true")
    p.add_argument("--show", action="store_true",
                   help="display figures interactively")
    p.add_argument("--ckpt-dir", type=str, default=None,
                   help="orbax checkpoint dir: resume the VMC optimization "
                        "from the latest saved epoch")
    p.add_argument("--manifest", type=str, default="vmc_run_manifest.json",
                   help="run-manifest JSON path ('' to disable)")


def cmd_bench(args) -> int:
    from jax_tpus_benchmark_physics_simulation_tpu.report.export import write_csv
    from jax_tpus_benchmark_physics_simulation_tpu.utils.deps import check_dependencies

    check_dependencies()

    if getattr(args, "reference_conv", False):
        # the reference's exact conv sizing (tpus_benchmark...:33-34,141-155)
        args.conv_size, args.batch_size = 64, 8
        args.conv_cin, args.conv_cout = 3, 64

    cfg = cfgs.BenchConfig(
        warmup=max(0, args.warmup),
        repeats=max(1, args.repeats),
        steps=max(1, args.steps),
        matrix_size=max(1, args.matrix_size),
        matrix_depth=max(1, args.matrix_depth),
        conv_size=max(1, args.conv_size),
        batch_size=max(1, args.batch_size),
        conv_cin=max(1, args.conv_cin),
        conv_cout=max(1, args.conv_cout),
        precision=args.precision,
        max_cores=args.max_cores,
        ops=tuple(s.strip() for s in args.ops.split(",") if s.strip())
        if args.ops
        else None,
    )
    from jax_tpus_benchmark_physics_simulation_tpu.bench import (
        device_rows,
        run_sweep,
        system_info,
    )

    console.kv_table("System Information", system_info())
    console.records_table("JAX Devices", device_rows())
    results = run_sweep(cfg, log=console.log)
    if not results:
        console.log("[yellow]No benchmark results collected.[/yellow]")
        return 1
    console.records_table(
        "Benchmark Results",
        results,
        ["test", "cores", "tflops", "xla_tflops", "bandwidth_gbs", "xla_gbs",
         "precision", "avg_ms", "error"],
    )
    if args.csv:
        write_csv(results, args.csv, append=args.csv_append)
        console.log(f"CSV written: {args.csv}")
    ok_rows = [r for r in results if "error" not in r]
    if not args.no_plot and args.plot and ok_rows:
        from jax_tpus_benchmark_physics_simulation_tpu.report.plots import (
            plot_benchmark_results,
        )

        out = plot_benchmark_results(ok_rows, args.plot, show=args.show)
        console.log(f"Plot saved: {out}")
    _write_manifest(args, "bench", cfg, {"results": results})
    failed = [r["test"] for r in results if "error" in r]
    if failed:
        console.log(f"[WARNING] benchmark rows failed: {', '.join(failed)}")
        return 1
    return 0


def _write_manifest(args, workload: str, cfg, results: dict) -> None:
    path = getattr(args, "manifest", "")
    if not path:
        return
    from jax_tpus_benchmark_physics_simulation_tpu.report.manifest import write_manifest

    console.log(f"Manifest: {write_manifest(path, workload, cfg, results)}")


def cmd_md(args) -> int:
    from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid

    cfg = override(
        MDConfig(),
        n=args.N,
        dim=args.dim,
        rho=args.rho,
        kt=args.kT,
        dt=args.dt,
        eq_steps=args.eq_steps,
        prod_steps=args.prod_steps,
        sample_every=args.sample_every,
        seed=args.seed,
        cutoff=args.cutoff,
        force_impl=getattr(args, "force_impl"),
        init=args.init,
        thermostat=getattr(args, "thermostat", "none"),
        gamma=getattr(args, "gamma", 1.0),
    )
    ens = "NVE" if cfg.thermostat == "none" else f"NVT (langevin, gamma={cfg.gamma})"
    console.panel(
        f"N={cfg.n}  rho={cfg.rho}  kT={cfg.kt}  box={cfg.box_size:.2f}\n"
        f"steps: {cfg.eq_steps:,} eq / {cfg.prod_steps:,} prod  dt={cfg.dt}\n"
        f"force: {lj_fluid.resolve_impl(cfg)}  cutoff={cfg.cutoff}  ensemble: {ens}",
        title="Molecular Dynamics",
    )
    if getattr(args, "profile", None):
        from jax_tpus_benchmark_physics_simulation_tpu.utils.profiling import trace

        with trace(args.profile):
            res = lj_fluid.run(cfg, ckpt_dir=getattr(args, "ckpt_dir", None))
        console.log(f"profiler trace: {args.profile} (view with tensorboard/xprof)")
    else:
        with console.progress() as prog:
            res = lj_fluid.run(
                cfg, ckpt_dir=getattr(args, "ckpt_dir", None), progress=prog
            )
    console.records_table(
        "Simulation Summary",
        [
            {"phase": "Compile", "time_s": res.time_compile_s, "detail": "XLA compile / cache load"},
            {"phase": "Equilibration", "time_s": res.time_eq_s, "detail": f"{cfg.eq_steps:,} steps"},
            {"phase": "Production", "time_s": res.time_prod_s, "detail": f"{cfg.prod_steps:,} steps"},
            {"phase": "g(r)", "time_s": res.time_rdf_s, "detail": f"{res.r_history.shape[0]} snapshots"},
        ],
        ["phase", "time_s", "detail"],
    )
    import math

    drift = res.energy_drift
    if cfg.thermostat != "none":
        # the thermostat exchanges energy with the bath by design — the
        # NVE conservation metric does not apply
        drift_s = "n/a (NVT: thermostat exchanges energy with the bath)"
    elif math.isfinite(drift):
        drift_s = f"{drift:.2e}"
    else:
        drift_s = "n/a (singular start: uniform init allows particle overlaps; use --init lattice)"
    p_s = f"; P* = {res.pressure:.4f}" if math.isfinite(res.pressure) else ""
    _, d_coef, d_resid = res.transport()
    d_s = (
        f"; D* = {d_coef:.4e} (fit rms {d_resid:.1e})"
        if math.isfinite(d_coef)
        else ""
    )
    prod_psps = cfg.n * cfg.prod_steps / max(res.time_prod_s, 1e-12)
    console.log(
        f"throughput: {res.particle_steps_per_sec / 1e6:.2f}M particle-steps/s "
        f"(production phase, equilibrated: {prod_psps / 1e6:.2f}M); "
        f"energy drift: {drift_s}{p_s}{d_s}"
    )
    if res.overflow:
        console.log(
            "[WARNING] spatial-structure capacity/skin OVERFLOW was flagged: "
            "pair interactions may have been missed; results are suspect "
            "(increase --cutoff skin margin or reduce --dt). Exit status 1."
        )
    if res.rdf_subset:
        console.log(
            f"note: g(r) estimated from a {res.rdf_subset}-particle random "
            f"subset of the {cfg.n:,} particles (unbiased, higher variance)."
        )
    if args.output:
        from jax_tpus_benchmark_physics_simulation_tpu.report.plots import plot_rdf

        out = plot_rdf(res.rdf_r, res.rdf_g, cfg.n, cfg.rho, cfg.kt, args.output,
                       show=getattr(args, "show", False))
        console.log(f"Plot saved: {out}")
    msd_out = getattr(args, "msd_output", None)
    if msd_out:
        msd_curve, _, _ = res.transport()
        if msd_curve is not None:
            from jax_tpus_benchmark_physics_simulation_tpu.report.plots import (
                plot_msd,
            )

            console.log(
                "Plot saved: "
                + plot_msd(msd_curve, res.dt_sample, d_coef, msd_out,
                           show=getattr(args, "show", False))
            )
        else:
            console.log("MSD plot skipped: needs >= 4 production samples")
    _write_manifest(
        args, "md", cfg,
        {
            "time_eq_s": res.time_eq_s,
            "time_prod_s": res.time_prod_s,
            "time_rdf_s": res.time_rdf_s,
            "particle_steps_per_sec": res.particle_steps_per_sec,
            "energy_drift": drift,
            "pressure": res.pressure,
            "diffusion_coefficient": d_coef,
            "overflow": res.overflow,
            "rdf_subset": res.rdf_subset,
        },
    )
    return 1 if res.overflow else 0


def cmd_mdscale(args) -> int:
    import jax

    from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu.parallel.scaling import (
        md_scaling_sweep,
    )
    from jax_tpus_benchmark_physics_simulation_tpu.report.export import write_csv

    cfg = override(
        MDConfig(), n=args.N, dim=args.dim, rho=args.rho, kt=args.kT, dt=args.dt,
        cutoff=args.cutoff, init="lattice",  # sane start; uniform init's
        # particle overlaps eject particles at skin-violating speeds
    )
    console.panel(
        f"N={cfg.n:,}  dim={cfg.dim}  mode={args.mode}  steps={args.steps}  "
        f"devices available={jax.device_count()} ({jax.default_backend()})",
        title="MD Scaling Sweep (sharded grid engine)",
    )
    rows = md_scaling_sweep(
        cfg,
        devices=args.devices,
        mode=args.mode,
        steps=args.steps,
        parity_steps=args.parity_steps,
        log=console.log,
    )
    if not rows:
        console.log("[yellow]no sweep points ran[/yellow]")
        return 1
    console.records_table(
        "MD Scaling", rows,
        ["devices", "n", "ms_per_step", "psps", "efficiency_pct", "parity_ok"],
    )
    if args.csv:
        write_csv(rows, args.csv)
        console.log(f"CSV written: {args.csv}")
    # manifest BEFORE the parity early-return: a failed parity sweep is the
    # run that most needs an audit record (advisor finding, round 2)
    parity_failed = any(r["parity_ok"] is False for r in rows)
    _write_manifest(args, "mdscale", cfg, {"rows": rows, "parity_failed": parity_failed})
    if parity_failed:
        console.log("[WARNING] sharded trajectory parity FAILED on some points")
        return 1
    return 0


def cmd_nbody(args) -> int:
    from jax_tpus_benchmark_physics_simulation_tpu.core.config import NBodyConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu.models import nbody_merger

    if args.interactive:
        from rich.prompt import FloatPrompt, IntPrompt, Prompt

        args.n_bodies = IntPrompt.ask("Number of black holes (2-5 recommended)", default=3)
        args.masses = [
            FloatPrompt.ask(f"Mass of BH{i + 1} (Msun)", default=30.0)
            for i in range(args.n_bodies)
        ]
        args.initial_distance = FloatPrompt.ask("Typical initial separation", default=100.0)
        args.initial_velocity = FloatPrompt.ask("Typical initial velocity (v/c)", default=0.1)
        args.sim_time = FloatPrompt.ask("Simulation time", default=200.0)
        args.d_gw = FloatPrompt.ask("GW observer distance (Mpc)", default=410.0)
        args.no_chaos = Prompt.ask("Compute Lyapunov exponent? (y/n)", default="y") != "y"

    masses = tuple(args.masses) if args.masses else tuple([30.0] * args.n_bodies)
    cfg = override(
        NBodyConfig(),
        n_bodies=args.n_bodies,
        masses=masses,
        initial_distance=args.initial_distance,
        initial_velocity=args.initial_velocity,
        sim_time=args.sim_time,
        d_gw_mpc=args.d_gw,
        num_steps=args.num_steps,
        compute_chaos=not args.no_chaos,
        lyapunov_method=args.lyapunov,
    )
    console.panel(
        f"bodies={cfg.n_bodies} masses={masses} sep={cfg.initial_distance} "
        f"v/c={cfg.initial_velocity}\nT={cfg.sim_time} steps={cfg.num_steps} "
        f"D_gw={cfg.d_gw_mpc} Mpc",
        title="N-Body BH Merger",
    )
    res = nbody_merger.run(cfg, ckpt_dir=getattr(args, "ckpt_dir", None))
    if res.sim_wall_s == 0.0:
        console.log("trajectory restored from checkpoint (simulation skipped)")
    else:
        console.log(f"simulation: {res.sim_wall_s * 1000:.2f} ms (one fused device program)")
    if res.lyapunov is not None:
        console.log(
            f"Lyapunov exponent ({cfg.lyapunov_method}): {res.lyapunov:.3f} "
            "(positive = chaotic orbit)"
        )
    if not args.no_media:
        from jax_tpus_benchmark_physics_simulation_tpu.report.export import (
            write_json,
            write_wav,
        )
        from jax_tpus_benchmark_physics_simulation_tpu.report.media import merger_gif
        from jax_tpus_benchmark_physics_simulation_tpu.report.plots import (
            plot_gw_strain,
            plot_trajectories_3d,
        )
        import numpy as np

        console.log(f"GW plot: {plot_gw_strain(res.t, res.h_plus)}")
        write_wav(np.asarray(res.h_plus), "n_body_gw.wav")
        console.log("GW audio: n_body_gw.wav")
        console.log(f"3D plot: {plot_trajectories_3d(res.t, res.positions)}")
        console.log(f"GIF: {merger_gif(res.t, res.positions, res.h_plus)}")
        write_json(
            {
                "t": np.asarray(res.t),
                "positions": np.asarray(res.positions),
                "h_plus": np.asarray(res.h_plus),
            },
            "n_body_data.json",
        )
        console.log("Data: n_body_data.json")
    import numpy as np

    _write_manifest(
        args, "nbody", cfg,
        {
            "sim_wall_s": res.sim_wall_s,
            "lyapunov": res.lyapunov,
            "trajectory_finite": bool(
                np.isfinite(np.asarray(res.positions)).all()
                and np.isfinite(np.asarray(res.h_plus)).all()
            ),
        },
    )
    return 0


def cmd_em3(args) -> int:
    from jax_tpus_benchmark_physics_simulation_tpu.core.config import EM3Config, override
    from jax_tpus_benchmark_physics_simulation_tpu.models import em_three_particles as em3

    cfg = override(
        EM3Config(),
        dt=args.dt,
        n_steps=args.n_steps,
        g=args.G,
        bz=args.Bz,
        bk=args.Bk,
        ex=args.Ex,
        ey=args.Ey,
        integrator=args.integrator,
    )
    res = em3.run(cfg)
    console.log(
        f"em3: {cfg.n_steps} steps in {res.wall_time_s * 1000:.2f} ms "
        f"({cfg.integrator} integrator, one fused device program)"
    )
    if not args.no_media:
        from jax_tpus_benchmark_physics_simulation_tpu.report.media import scatter_gif

        console.log(f"GIF: {scatter_gif(res.trajectory, 'three_particles_em_nonuni.gif')}")
    import numpy as np

    _write_manifest(
        args, "em3", cfg,
        {
            "wall_time_s": res.wall_time_s,
            "trajectory_finite": bool(np.isfinite(np.asarray(res.trajectory)).all()),
        },
    )
    return 0


def cmd_vmc(args) -> int:
    from jax_tpus_benchmark_physics_simulation_tpu.core.config import VMCDMCConfig, override
    from jax_tpus_benchmark_physics_simulation_tpu.models import quantum_oscillator

    cfg = override(
        VMCDMCConfig(),
        n_walkers=args.n_walkers,
        n_epochs=args.n_epochs,
        n_equil=args.n_equil,
        step_size=args.step_size,
        lr=args.lr,
        n_dmc=args.n_dmc,
        dmc_dt=args.dmc_dt,
        dim=args.dim,
        resampler=args.resampler,
        potential=args.potential,
        lam=args.lam,
        snapshot_every=0 if args.no_gif else 25,
    )
    pot = cfg.potential + (f" (lam={cfg.lam})" if cfg.potential == "anharmonic" else "")
    console.panel(
        f"walkers={cfg.n_walkers:,} dim={cfg.dim} epochs={cfg.n_epochs:,} "
        f"equil/epoch={cfg.n_equil}\nlr={cfg.lr} dmc_steps={cfg.n_dmc} "
        f"dmc_dt={cfg.dmc_dt} resampler={cfg.resampler} potential={pot}",
        title="VMC + DMC",
    )
    # live per-epoch-chunk E/alpha readout on a real progress bar (parity
    # with the reference's bar + live readout, vmc_dmc...:133-154)
    with console.progress() as prog:
        task = prog.add_task(f"VMC ({cfg.n_epochs:,} epochs)", total=cfg.n_epochs)

        def _tick(epoch, energy, alpha):
            prog.update(
                task,
                completed=epoch,
                description=f"VMC epoch {epoch:,}  E={energy:9.6f}  alpha={alpha:.6f}",
            )

        res = quantum_oscillator.run(
            cfg, progress_cb=_tick, ckpt_dir=getattr(args, "ckpt_dir", None)
        )
    alpha_note = f"(exact {res.exact_alpha})" if res.exact_alpha is not None else "(no closed form)"
    console.log(
        f"VMC  : E = {res.vmc_energy:.6f} (exact {res.exact_energy:.6f}), "
        f"alpha = {res.vmc_alpha:.6f} {alpha_note}  "
        f"[{res.vmc_wall_s:.1f}s]"
    )
    mean, err = res.dmc.mean_energy()
    console.log(
        f"DMC  : E = {float(mean):.6f} +- {float(err):.6f} (exact {res.exact_energy:.6f})  "
        f"[{res.dmc_wall_s:.1f}s]"
    )
    if not args.no_plot:
        import jax

        from jax_tpus_benchmark_physics_simulation_tpu.report.plots import (
            plot_dmc_energy,
            plot_vmc_history,
            plot_walker_comparison,
        )

        console.log(
            "plots: "
            + plot_vmc_history(
                res.vmc.energy_history,
                jax.tree.leaves(res.vmc.params_history)[0],  # alpha track
                res.exact_energy, res.exact_alpha,
            )
            + ", "
            + plot_dmc_energy(res.dmc.energy_history, res.exact_energy)
            + ", "
            + plot_walker_comparison(
                res.vmc.walkers, res.dmc.walkers, exact_sigma=1.0 / (2.0**0.5)
            )
        )
    if not args.no_gif:
        from jax_tpus_benchmark_physics_simulation_tpu.report.media import (
            walker_histogram_gif,
        )

        import numpy as np

        if res.vmc.walker_snapshots is not None and len(res.vmc.walker_snapshots):
            snaps = np.asarray(res.vmc.walker_snapshots)
            gif = walker_histogram_gif(
                snaps,
                labels=[f"VMC epoch block {i}" for i in range(len(snaps))],
                output="vmc_animation.gif",
                exact_sigma=1.0 / (2.0**0.5),
            )
            console.log(f"VMC GIF: {gif}")
        if res.dmc.walker_snapshots is not None and len(res.dmc.walker_snapshots):
            snaps = np.asarray(res.dmc.walker_snapshots)
            gif = walker_histogram_gif(
                snaps,
                labels=[f"DMC step {i * cfg.snapshot_every}" for i in range(len(snaps))],
                output="dmc_animation.gif",
                exact_sigma=1.0 / (2.0**0.5),
            )
            console.log(f"DMC GIF: {gif}")
    _write_manifest(
        args, "vmc", cfg,
        {
            "vmc_energy": res.vmc_energy,
            "vmc_alpha": res.vmc_alpha,
            "dmc_energy": float(mean),
            "dmc_energy_err": float(err),
            "exact_energy": res.exact_energy,
            "exact_alpha": res.exact_alpha,
            "vmc_wall_s": res.vmc_wall_s,
            "dmc_wall_s": res.dmc_wall_s,
        },
    )
    return 0


def cmd_devices(args) -> int:
    from jax_tpus_benchmark_physics_simulation_tpu.bench import device_rows

    console.records_table("JAX Devices", device_rows())
    return 0


def cmd_check_deps(args) -> int:
    from jax_tpus_benchmark_physics_simulation_tpu.utils.deps import check_dependencies

    return 0 if check_dependencies() else 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="jtps",
        description="JAX particle-simulation + benchmark framework",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    _add_bench(sub)
    _add_md(sub)
    _add_mdscale(sub)
    _add_nbody(sub)
    _add_em3(sub)
    _add_vmc(sub)
    sub.add_parser("devices", help="list JAX devices")
    sub.add_parser("check-deps", help="verify required libraries")

    args = parser.parse_args(argv)
    if getattr(args, "virtual", 0):
        # must happen before JAX initializes a backend; pin the CPU platform
        # via jax.config as well (authoritative over the environment)
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}"
        )
        import jax

        jax.config.update("jax_platforms", "cpu")
    from jax_tpus_benchmark_physics_simulation_tpu.utils.cache import (
        enable_compilation_cache,
    )

    enable_compilation_cache()
    commands = {
        "bench": cmd_bench,
        "md": cmd_md,
        "mdscale": cmd_mdscale,
        "nbody": cmd_nbody,
        "em3": cmd_em3,
        "vmc": cmd_vmc,
        "devices": cmd_devices,
        "check-deps": cmd_check_deps,
    }
    return commands[args.command](args)


if __name__ == "__main__":
    sys.exit(main())

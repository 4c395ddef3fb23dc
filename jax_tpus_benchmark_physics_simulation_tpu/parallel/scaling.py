"""Multi-chip MD scaling harness: strong/weak scaling of the sharded
grid-resident engine over a device mesh, with single-chip trajectory parity.

One command produces the scaling table on any device set. Without several
accelerators, run it on the virtual CPU mesh (``jtps mdscale --virtual 8``)
— same code path, real collectives, compiled by XLA for the host platform;
on a multi-GPU host the same command measures NCCL-backed scaling.

Strong scaling: fixed N, rows split over devices. Weak scaling: N grows with
the device count (fixed per-device work; the box grows as N^(1/dim), so the
cell-row count must stay divisible — sizes are rounded to keep every sweep
point valid, and the actual N used is reported).
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import jax

from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu.parallel.grid_md_sharded import (
    ShardedGridMD,
)
from jax_tpus_benchmark_physics_simulation_tpu.parallel.mesh import make_mesh


def _build_engine(cfg: MDConfig, n_devices: int):
    skin = cfg.skin
    if skin is None:  # md_scaling_sweep materializes; direct callers may not
        skin = lj_fluid.resolve_skin(cfg, "grid", n_devices=n_devices)
    gf = make_cell_grid_fn(
        cfg.box_size, cfg.cutoff, cfg.n, dim=cfg.dim, skin=skin, rho=cfg.rho
    )
    kw = dict(sigma=cfg.sigma, epsilon=cfg.epsilon, dt=cfg.dt, compensated=cfg.compensated)
    if cfg.dim == 3:
        from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import (
            GridMD3,
        )
        from jax_tpus_benchmark_physics_simulation_tpu.parallel.grid_md3_sharded import (
            ShardedGridMD3,
        )

        # same engines as lj_fluid._make_grid_md
        if n_devices == 1:
            return GridMD3(gf, **kw), gf
        if gf.cells_per_side % n_devices:
            return None, gf
        return ShardedGridMD3(gf, make_mesh(n_devices, axis_name="x"), **kw), gf
    if n_devices == 1:
        return GridMD(gf, **kw), gf
    if gf.cells_per_side % n_devices:
        return None, gf  # divisibility gate (caller reports the skip)
    return ShardedGridMD(gf, make_mesh(n_devices, axis_name="x"), **kw), gf


def _time_steps(md, gs, n_inner: int, n_chunks: int, repeats: int = 3,
                gate_frac: float = 0.25) -> float:
    """Best-of wall seconds for ``n_chunks * n_inner`` fused steps under the
    cond-free production driver."""
    run = jax.jit(
        md.make_production_run(n_chunks * n_inner, n_inner, gate_frac=gate_frac)
    )

    gs = jax.block_until_ready(run(gs))  # compile + warmup
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        gs = jax.block_until_ready(run(gs))
        best = min(best, time.perf_counter() - t0)
    if bool(gs.overflow):
        raise RuntimeError(
            "scaling sweep: capacity/skin overflow during timing (never "
            "silent — reduce dt or raise skin)"
        )
    return best


def _lcm(devices: List[int]) -> int:
    import math

    lcm = 1
    for d in devices:
        lcm = lcm * d // math.gcd(lcm, d)
    return lcm


def _round_to_divisible_n(n: int, cfg: MDConfig, devices: List[int]) -> int:
    """Largest n' <= n whose cell-row count divides every mesh size (keeps
    all strong-scaling points valid)."""
    lcm = _lcm(devices)
    skin = cfg.skin
    if skin is None:
        skin = lj_fluid.resolve_skin(
            override(cfg, n=n), "grid", n_devices=lcm
        )
    cell = cfg.cutoff + skin
    box = (n / cfg.rho) ** (1.0 / cfg.dim)
    cps = int(box / cell)
    cps -= cps % lcm
    if cps < max(3, lcm):
        raise ValueError(
            f"N={n} too small for a {lcm}-divisible cell grid (cps={cps})"
        )
    # 0.1-cell margin: box exactly on the cps*cell boundary can truncate to
    # cps-1 in make_cell_grid_fn's int(box/cell) and break divisibility.
    # Clamped to the requested n: when box/cell lands inside [cps, cps+0.1)
    # the margin alone could otherwise return n' > n (advisor finding).
    box = (cps + 0.1) * cell
    return min(n, int(cfg.rho * box**cfg.dim))


def md_scaling_sweep(
    base: MDConfig,
    devices: Optional[List[int]] = None,
    mode: str = "strong",
    steps: int = 200,
    parity_steps: int = 50,
    log: Callable[[str], None] = print,
) -> List[dict]:
    """Run the sweep; returns rows
    {devices, n, ms_per_step, psps, efficiency_pct, parity_ok}.

    Parity: every multi-device point re-runs ``parity_steps`` fused steps
    from the same initial state on 1 device and on the mesh and compares
    positions (the halo/reaction machinery must reproduce the single-chip
    trajectory bit-for-tolerance, not just "run").
    """
    if devices is None:
        avail = jax.device_count()
        devices = sorted({1} | {2**k for k in range(1, 10) if 2**k <= avail} | {avail})
    assert base.cutoff is not None, "mdscale requires a cutoff (grid engine)"
    if base.skin is None:
        # materialize the auto skin ONCE for the whole sweep: every point
        # (and the 1-device parity re-run) must build the same geometry
        base = override(
            base, skin=lj_fluid.resolve_skin(base, "grid", n_devices=_lcm(devices))
        )
    rows: List[dict] = []
    t_ref = None
    for d in devices:
        cfg = base
        if mode == "weak":
            cfg = override(base, n=_round_to_divisible_n(base.n * d, base, [d]))
        else:
            cfg = override(base, n=_round_to_divisible_n(base.n, base, devices))
        md, gf = _build_engine(cfg, d)
        if md is None:
            log(f"[mdscale] skip {d} devices: cps {gf.cells_per_side} not divisible")
            continue
        state = lj_fluid.init_state(cfg)
        gs = md.prepare(md.init(state.position, state.velocity))
        k, gate = lj_fluid._grid_inner_steps(cfg, md)
        n_chunks = max(1, steps // k)
        wall = _time_steps(md, gs, k, n_chunks, gate_frac=gate)
        n_steps = n_chunks * k
        ms = wall / n_steps * 1e3
        psps = cfg.n * n_steps / wall
        parity_ok = None
        if d > 1 and parity_steps:
            parity_ok = _check_parity(cfg, md, state, parity_steps)
        if mode == "strong":
            if t_ref is None:
                t_ref = ms
            eff = t_ref / (ms * d) * 100.0
        else:
            if t_ref is None:
                t_ref = ms
            eff = t_ref / ms * 100.0  # weak: constant ms/step = 100%
        rows.append(
            {
                "devices": d,
                "n": cfg.n,
                "ms_per_step": ms,
                "psps": psps,
                "efficiency_pct": eff,
                "parity_ok": parity_ok,
            }
        )
        log(
            f"[mdscale] {d} device(s): N={cfg.n:,} {ms:8.3f} ms/step "
            f"{psps / 1e6:9.2f}M psps  eff={eff:5.1f}%"
            + (f"  parity={'OK' if parity_ok else 'FAIL'}" if parity_ok is not None else "")
        )
    return rows


def _check_parity(cfg: MDConfig, md_multi, state, steps: int) -> bool:
    """Sharded trajectory == single-device trajectory from the same init."""
    import numpy as np

    md_one, _ = _build_engine(cfg, 1)
    k_auto, gate = lj_fluid._grid_inner_steps(cfg, md_one)
    k = min(steps, k_auto)
    n_chunks = max(1, steps // k)

    def run(md):
        gs = md.prepare(md.init(state.position, state.velocity))
        chunk = md.make_chunk_step(k, gate_frac=gate)
        gs = jax.jit(lambda s: jax.lax.fori_loop(0, n_chunks, lambda i, t: chunk(t), s))(gs)
        return np.asarray(md.positions(gs))

    p1 = run(md_one)
    pd = run(md_multi)
    return bool(np.allclose(p1, pd, rtol=2e-4, atol=2e-4))

"""Benchmark runners: timing harness + multi-device scaling sweep.

Reference: the five ``benchmark_jax_*`` functions + ``benchmark_multiple_cores``
(tpus_benchmark...:177-650). Same measurement discipline (warmup loop with
per-step sync, then a timed dispatch loop with one trailing sync, :207-215),
same result-dict schema ({test, cores, tflops|bandwidth_gbs, avg_ms}) so the
CSV/plot layer is drop-in compatible.

Differences from the reference:
- multi-device execution is ``shard_map`` over a 1-D mesh (inputs stacked on
  a leading device axis — pmap semantics, modern mechanism);
- the conv op is included in the sweep (dead in the reference);
- bandwidth uses an honest fused streaming op (ops.py: read + write per pass);
- matmul-type rows (2D, 3D, Conv) record the precision they ran at: float32
  runs in TF32 on the GPU unless ``jax_default_matmul_precision`` asks for
  ``highest``;
- OOM -> skip with suggestions, divisibility gates, KeyboardInterrupt salvage
  are all preserved (reference :221-235, :262-265, :698-700).
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from functools import partial
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from jax_tpus_benchmark_physics_simulation_tpu.bench import flops as flops_mod
from jax_tpus_benchmark_physics_simulation_tpu.bench import ops as ops_mod
from jax_tpus_benchmark_physics_simulation_tpu.core.config import BenchConfig
from jax_tpus_benchmark_physics_simulation_tpu.parallel.mesh import make_mesh


def _is_oom(e: Exception) -> bool:
    msg = str(e).upper()
    return "RESOURCE_EXHAUSTED" in msg or "OOM" in msg


@dataclass
class BenchContext:
    cfg: BenchConfig
    log: Callable[[str], None] = print

    @property
    def precision(self):
        return jnp.bfloat16 if self.cfg.precision == "bfloat16" else jnp.float32

    @property
    def bytes_per_element(self) -> int:
        return 2 if self.cfg.precision == "bfloat16" else 4


def precision_label(ctx: BenchContext, matmul: bool) -> str:
    """The arithmetic a row ran at. float32 matrix products run in TF32 on
    the GPU unless the default matmul precision says ``highest``."""
    if ctx.cfg.precision == "bfloat16":
        return "bfloat16"
    if not matmul:
        return "float32"
    asked = jax.config.jax_default_matmul_precision or "default"
    if asked in ("highest", "float32"):
        return "float32 (highest)"
    if jax.default_backend() == "gpu":
        return "float32 (TF32)"
    return f"float32 ({asked})"


def _timed_loop(ctx: BenchContext, op, args, cores: int, chain: str = "perturb") -> float:
    """Measure avg seconds per op with the iteration loop FUSED ON DEVICE.

    The reference times a host dispatch loop (:210-215), which measures the
    dispatcher as much as the op. Here ``steps`` iterations run inside one
    jitted ``fori_loop`` with a serial data dependency between iterations
    (so XLA cannot hoist or elide the op), and each timed execution ends in
    ``block_until_ready``.

    ``chain``: "direct" feeds the output straight back as the input
    (copy-type ops, exact traffic); "perturb" adds a 1e-30-scaled tap of the
    output to the original input (keeps values sane for compounding ops).
    ``x0`` may be a pytree (the bandwidth op carries a tuple of independent
    streams so iterations can overlap — see ops.make_bandwidth_op).
    """
    steps = ctx.cfg.steps

    def loop_body(x0, rest):
        def body(i, x):
            out = op(x, *rest)
            if chain == "direct":
                return out
            tap = out if out.ndim == 0 else jnp.sum(out)
            return x0 + (tap * 1e-30).astype(x0.dtype)

        x = jax.lax.fori_loop(0, steps, body, x0)
        return sum(jnp.sum(leaf) for leaf in jax.tree.leaves(x))

    if cores == 1:
        compiled = jax.jit(loop_body)
    else:
        mesh = make_mesh(cores, axis_name="bench")

        def sharded(x0, rest):
            drop = lambda t: jax.tree.map(lambda a: a[0], t)
            return jax.shard_map(
                lambda x, *r: loop_body(drop(x), [drop(q) for q in r])[None],
                mesh=mesh,
                in_specs=(P("bench"),) + tuple(P("bench") for _ in rest),
                out_specs=P("bench"),
            )(x0, *rest)

        compiled = jax.jit(lambda x0, rest: jnp.sum(sharded(x0, rest)))

    x0, rest = args[0], list(args[1:])
    # warmup = untimed executions (first one compiles); each covers ``steps``
    # op iterations, so warmup=1 >= the reference's 10 iterations (:207-208).
    for _ in range(max(1, ctx.cfg.warmup)):
        jax.block_until_ready(compiled(x0, rest))
    best = float("inf")
    for _ in range(max(1, ctx.cfg.repeats)):
        start = time.perf_counter()
        jax.block_until_ready(compiled(x0, rest))
        best = min(best, time.perf_counter() - start)
    return max(best, 1e-9) / steps


def _alloc_normal(key, cores: int, shape_per_core, dtype):
    """Per-core PRNG streams stacked on the device axis (reference :196-201)."""
    if cores == 1:
        return jax.random.normal(key, shape_per_core, dtype=dtype)
    keys = jax.random.split(key, cores)
    return jax.vmap(lambda k: jax.random.normal(k, shape_per_core, dtype=dtype))(keys)


def _xla_cost(op, args) -> dict:
    """Roofline columns from the COMPILER's own counts (SURVEY.md §7 step 8):
    lower + compile one bare op application and read ``cost_analysis()``.
    The analytic formulas (flops.py) are the reference's spec; these are what
    XLA actually scheduled — reported side by side so a number like "0.2
    TFLOPS" for FFT can be seen for what it is (bandwidth-bound, not slow).
    """
    try:
        c = jax.jit(op).lower(*args).compile().cost_analysis() or {}
        out = {}
        if c.get("flops"):
            out["xla_flops"] = float(c["flops"])
        if c.get("bytes accessed"):
            out["xla_bytes"] = float(c["bytes accessed"])
        return out
    except Exception:  # pragma: no cover - backend-dependent
        return {}


def _run_op(
    ctx, name, cores, op, arg_maker,
    flops_per_call=None, bytes_per_call=None, chain="perturb", oom_hint="",
    matmul=False,
):
    try:
        args = arg_maker()
        jax.block_until_ready(args)
        avg = _timed_loop(ctx, op, args, cores, chain=chain)
    except Exception as e:  # noqa: BLE001
        if _is_oom(e):
            ctx.log(
                f"[bench] OOM in {name} @ {cores} cores — skipping."
                + (f" Try: {oom_hint}" if oom_hint else "")
            )
            return None
        ctx.log(f"[bench] error in {name} @ {cores} cores: {e}")
        ctx.log(traceback.format_exc())
        return {"test": name, "cores": cores, "error": f"{type(e).__name__}: {e}"}

    result = {
        "test": name,
        "cores": cores,
        "precision": precision_label(ctx, matmul),
        "avg_ms": avg * 1e3,
    }
    if flops_per_call is not None:
        result["tflops"] = flops_per_call / avg / 1e12
    if bytes_per_call is not None:
        result["bandwidth_gbs"] = bytes_per_call / avg / (1024**3)
    if cores == 1:  # per-device roofline (same compiled op at every core count)
        cost = _xla_cost(op, args)
        if "xla_flops" in cost:
            result["xla_tflops"] = cost["xla_flops"] / avg / 1e12
        if "xla_bytes" in cost:
            result["xla_gbs"] = cost["xla_bytes"] / avg / (1024**3)
    ctx.log(
        f"[bench] {name:9s} cores={cores}: {avg * 1e3:9.3f} ms  "
        + (f"{result.get('tflops', 0):8.2f} TFLOPS" if flops_per_call else "")
        + (f"{result.get('bandwidth_gbs', 0):8.2f} GB/s" if bytes_per_call else "")
        + (
            f"  [xla: {result['xla_tflops']:.2f} TF"
            + (f", {result['xla_gbs']:.0f} GB/s" if "xla_gbs" in result else "")
            + "]"
            if "xla_tflops" in result
            else ""
        )
    )
    return result


# -- individual benchmarks ---------------------------------------------------

def benchmark_2d(ctx: BenchContext, cores: int):
    n = ctx.cfg.matrix_size
    shape = (n, n)

    def alloc():
        kx, ky = jax.random.split(jax.random.PRNGKey(0))
        per = shape if cores == 1 else shape
        return (
            _alloc_normal(kx, cores, per, ctx.precision),
            _alloc_normal(ky, cores, per, ctx.precision),
        )

    return _run_op(
        ctx, "2D", cores, ops_mod.op_2d, alloc,
        flops_per_call=flops_mod.matmul_chain_flops(n) * cores,
        oom_hint=f"-mxs {n // 2} (or {n // 4}, {n // 8})",
        matmul=True,
    )


def benchmark_3d(ctx: BenchContext, cores: int):
    cfg = ctx.cfg
    if cores > 1 and cfg.matrix_depth % cores != 0:
        ctx.log(f"[bench] skip 3D @ {cores} cores: depth {cfg.matrix_depth} not divisible")
        return None
    d_per = cfg.matrix_depth // cores
    shape = (d_per, cfg.matrix_size, cfg.matrix_size)

    def alloc():
        kx, ky = jax.random.split(jax.random.PRNGKey(42))
        return (
            _alloc_normal(kx, cores, shape, ctx.precision),
            _alloc_normal(ky, cores, shape, ctx.precision),
        )

    # concrete retry values, like the reference's 3D OOM handler (:313-321)
    hint = " or ".join(
        f"-md {cfg.matrix_depth // k}"
        for k in (2, 4, 8)
        if cfg.matrix_depth // k >= 1
    )
    return _run_op(
        ctx, "3D", cores, ops_mod.op_3d, alloc,
        flops_per_call=flops_mod.matmul_chain_flops(cfg.matrix_size) * cfg.matrix_depth,
        oom_hint=hint or f"-mxs {cfg.matrix_size // 2}",
        matmul=True,
    )


def benchmark_conv(ctx: BenchContext, cores: int):
    # Compute-bound by default (see BenchConfig docstring): the reference's
    # never-run conv (8x64x64, cin=3) is latency-bound.
    cfg = ctx.cfg
    cin, cout, kh = cfg.conv_cin, cfg.conv_cout, 3
    x_shape = (cfg.batch_size, cfg.conv_size, cfg.conv_size, cin)
    k_shape = (kh, kh, cin, cout)

    def alloc():
        kx, kk = jax.random.split(jax.random.PRNGKey(7))
        return (
            _alloc_normal(kx, cores, x_shape, ctx.precision),
            _alloc_normal(kk, cores, k_shape, ctx.precision),
        )

    return _run_op(
        ctx, "Conv", cores, ops_mod.op_conv, alloc,
        flops_per_call=flops_mod.conv_flops(
            cfg.batch_size, cfg.conv_size, kh, kh, cin, cout
        ) * cores,
        oom_hint=f"-b {cfg.batch_size // 2} or -c {cfg.conv_size // 2}",
        matmul=True,
    )


def benchmark_fft_2d(ctx: BenchContext, cores: int):
    n = ctx.cfg.matrix_size
    op = partial(ops_mod.op_fft_2d, precision=ctx.precision)

    def alloc():
        return (_alloc_normal(jax.random.PRNGKey(789), cores, (n, n), ctx.precision),)

    return _run_op(
        ctx, "2D_FFT", cores, op, alloc,
        flops_per_call=flops_mod.fft2d_flops(n) * cores,
        oom_hint=f"-mxs {n // 2}",
    )


def benchmark_fft_3d(ctx: BenchContext, cores: int):
    cfg = ctx.cfg
    if cores > 1 and cfg.matrix_depth % cores != 0:
        ctx.log(f"[bench] skip 3D_FFT @ {cores} cores: depth not divisible")
        return None
    d_per = cfg.matrix_depth // cores
    n = cfg.matrix_size
    op = partial(ops_mod.op_fft_3d, precision=ctx.precision)

    def alloc():
        return (
            _alloc_normal(jax.random.PRNGKey(1011), cores, (d_per, n, n), ctx.precision),
        )

    return _run_op(
        ctx, "3D_FFT", cores, op, alloc,
        flops_per_call=flops_mod.fft3d_flops(n, cfg.matrix_depth),
        oom_hint=f"-md {cfg.matrix_depth // 2} or -mxs {n // 2}",
    )


def benchmark_bandwidth(ctx: BenchContext, cores: int):
    # per-core sizing: the reference's min(64Mi elems, 256Mi total / cores)
    # (:359-365) — but in BYTES (256 MiB/core, 1 GiB total), converted to
    # elements per dtype, so f32 and bf16 move the same footprint, well
    # beyond any on-chip cache.
    bpe = ctx.bytes_per_element
    max_per_core = (256 * 1024 * 1024) // bpe
    requested_total = (1024 * 1024 * 1024) // bpe
    per_core = int(min(max_per_core, requested_total // max(cores, 1)))
    op = ops_mod.make_bandwidth_op(per_core, dtype=ctx.precision)

    def alloc():
        # tuple of independent streams (see ops.make_bandwidth_op): each is
        # its own loop carry so timed iterations overlap on the HBM pipeline
        return (
            tuple(
                _alloc_normal(
                    jax.random.PRNGKey(456 + i), cores,
                    (op.per_stream,), ctx.precision,
                )
                for i in range(op.n_streams)
            ),
        )

    return _run_op(
        ctx, "Bandwidth", cores, op, alloc,
        bytes_per_call=op.bytes_per_call * cores,
        chain="direct",  # copy output feeds the next copy: exact traffic
    )


ALL_BENCHMARKS = [
    ("2D", benchmark_2d),
    ("3D", benchmark_3d),
    ("Conv", benchmark_conv),
    ("2D_FFT", benchmark_fft_2d),
    ("3D_FFT", benchmark_fft_3d),
    ("Bandwidth", benchmark_bandwidth),
]


def compute_core_candidates(max_cores: int, available: Optional[int] = None) -> List[int]:
    """{1} + powers of two <= max + max itself, clipped to available
    (reference :593-620)."""
    if available is None:
        available = jax.device_count()
    cand = {1}
    p = 1
    while p <= max_cores:
        cand.add(p)
        p *= 2
    if max_cores >= 1:
        cand.add(max_cores)
    return sorted(c for c in cand if 0 < c <= available)


def run_sweep(cfg: BenchConfig, log: Callable[[str], None] = print) -> List[dict]:
    """Full sweep over core counts x ops, with KeyboardInterrupt salvage
    (reference :696-703). A failed op yields a row with an ``error`` key."""
    ctx = BenchContext(cfg, log)
    available = jax.device_count()
    max_cores = cfg.max_cores if cfg.max_cores > 0 else available
    max_cores = min(max_cores, available)
    benches = ALL_BENCHMARKS
    if cfg.ops is not None:
        wanted = {o.lower() for o in cfg.ops}
        known = {name.lower() for name, _ in ALL_BENCHMARKS}
        unknown = wanted - known
        if unknown:
            raise ValueError(
                f"unknown ops {sorted(unknown)}; known: "
                f"{[name for name, _ in ALL_BENCHMARKS]}"
            )
        benches = [(n, b) for n, b in ALL_BENCHMARKS if n.lower() in wanted]
    results: List[dict] = []
    try:
        for cores in compute_core_candidates(max_cores, available):
            log(f"[bench] === {cores} device(s) ===")
            for _name, bench in benches:
                res = bench(ctx, cores)
                if res:
                    results.append(res)
    except KeyboardInterrupt:
        log("[bench] interrupted — salvaging partial results")
    return results

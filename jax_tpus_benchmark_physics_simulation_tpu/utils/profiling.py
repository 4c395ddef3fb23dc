"""Profiling / tracing hooks (absent in the reference — SURVEY.md §5:
coarse perf_counter timing only).

- :func:`trace`: context manager around ``jax.profiler.trace`` (view with
  TensorBoard or xprof).
- :func:`cost_analysis`: XLA's per-executable FLOP/byte estimates from the
  compiled artifact.
- :func:`timeit_op`: warmup-then-measure timing, each window ending in
  ``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict

import jax


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/jax-trace"):
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


def cost_analysis(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Compile ``fn`` and return XLA's cost analysis (flops, bytes accessed,
    transcendentals, ...)."""
    lowered = jax.jit(fn).lower(*args, **kwargs)
    compiled = lowered.compile()
    return dict(compiled.cost_analysis() or {})


def timeit_op(
    fn: Callable,
    *args,
    warmup: int = 3,
    iters: int = 10,
) -> float:
    """Average seconds per call of the jitted ``fn``."""
    compiled = jax.jit(fn)
    for _ in range(warmup):
        jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = compiled(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters

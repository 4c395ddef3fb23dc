"""Benchmark ops (compute kernels under test).

Reference: tpus_benchmark_single-host_workload.py:125-175. Same compound
op structure (matmul -> transcendental mix -> matmul -> log/exp -> square,
chosen there to defeat trivial constant folding). Differences, documented:

- the conv op is actually benchmarked here (the reference defines ``op_conv``
  at :141-155 but never runs it — dead flags ``-c``/``-b``, SURVEY.md §2a);
- the bandwidth op is honest: the reference chains 10 ``jnp.copy`` (:157-163)
  which XLA elides/fuses, so its "GB/s" overcounts by up to 10x; ours times
  fused streaming passes and counts read+write bytes actually moved.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def op_2d(a, b):
    """Compound 2D matmul chain (reference :125-131)."""
    c = jnp.dot(a, b)
    d = jnp.tanh(c) + jnp.sin(c / (jnp.log(jnp.abs(a[0, 0]) + 1) * 2 + 1))
    e = jnp.dot(a, d)
    f = jnp.log1p(jnp.abs(e)) + jnp.exp(b * 0.001)
    return jnp.square(f)


def op_3d(a, b):
    """Compound batched matmul chain (reference :133-139)."""
    c = jnp.matmul(a, b)
    d = jnp.tanh(c) + jnp.sin(c / (jnp.log(jnp.abs(a[0, 0, 0]) + 1) * 2 + 1))
    e = jnp.matmul(a, d)
    f = jnp.log1p(jnp.abs(e)) + jnp.exp(b * 0.001)
    return jnp.square(f)


def op_conv(x, kernel):
    """NHWC conv + tanh + sum of squares (reference :141-155; actually run
    here). Kernel layout HWIO."""
    out = lax.conv_general_dilated(
        x,
        kernel,
        window_strides=(1, 1),
        padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    )
    return jnp.sum(jnp.tanh(out) ** 2)


def op_fft_2d(a, precision):
    """FFT -> inverse -> reconstruction error (reference :165-169)."""
    f = jnp.fft.fftn(a.astype(precision))
    rec = jnp.fft.ifftn(f).real
    return jnp.sum(jnp.abs(rec - a) ** 2)


def op_fft_3d(a, precision):
    f = jnp.fft.fftn(a.astype(precision))
    rec = jnp.fft.ifftn(f).real
    return jnp.sum(jnp.abs(rec - a) ** 2)


# -- honest bandwidth -----------------------------------------------------

def make_bandwidth_op(n_elems: int, dtype=jnp.float32, n_streams: int = 4):
    """Device-memory bandwidth op, counted as read + write of the full
    footprint: ``n_streams`` INDEPENDENT fused elementwise passes ``x_i + 1``
    over a tuple of buffers — one read + one write each, impossible for XLA
    to elide when the outputs feed the next iteration. The streams are
    independent loop carries so that the timed loop's iterations can
    overlap instead of serializing on one buffer. The op therefore takes
    and returns a TUPLE of arrays; the timed loop handles pytree carries.
    """
    per_stream = max(1, n_elems // n_streams)

    def op(xs):
        one = jnp.asarray(1.0, dtype)
        return tuple(x + one for x in xs)

    op.n_elems = per_stream * n_streams
    op.n_streams = n_streams
    op.per_stream = per_stream
    op.bytes_per_call = 2 * op.n_elems * jnp.dtype(dtype).itemsize
    return op

"""Benchmark suite tests (tiny sizes on the CPU mesh): all ops run, FLOP
models match the reference formulas, sweep core candidates, export/plot."""

import pytest

pytestmark = pytest.mark.slow  # compile-heavy: excluded from the fast tier

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax_tpus_benchmark_physics_simulation_tpu.bench import (
    compute_core_candidates,
    flops,
    ops,
    run_sweep,
    system_info,
)
from jax_tpus_benchmark_physics_simulation_tpu.core.config import BenchConfig, override


class TestFlopsModels:
    def test_matmul_chain_matches_reference_formula(self):
        n = 4096
        assert flops.matmul_chain_flops(n) == (2 * n**3 * 2) * 1.1

    def test_fft_formulas(self):
        n = 1024
        assert flops.fft2d_flops(n) == 10 * n * n * math.log2(n)
        assert flops.fft3d_flops(n, 6) == 15 * n * n * math.log2(n) * 6

    def test_degenerate_n(self):
        assert flops.fft2d_flops(1) == 0.0


class TestOps:
    def test_op_2d_finite(self):
        x = jax.random.normal(jax.random.PRNGKey(0), (64, 64))
        y = jax.random.normal(jax.random.PRNGKey(1), (64, 64))
        out = ops.op_2d(x, y)
        assert out.shape == (64, 64)
        assert np.all(np.isfinite(np.asarray(out)))

    def test_op_conv_runs(self):
        x = jax.random.normal(jax.random.PRNGKey(2), (2, 16, 16, 3))
        k = jax.random.normal(jax.random.PRNGKey(3), (3, 3, 3, 8))
        out = ops.op_conv(x, k)
        assert out.shape == ()

    def test_fft_roundtrip_error_small(self):
        x = jax.random.normal(jax.random.PRNGKey(4), (64, 64))
        err = ops.op_fft_2d(x, jnp.float32)
        assert float(err) < 1e-3

    def test_bandwidth_op_stream(self):
        op = ops.make_bandwidth_op(4096)
        assert op.n_streams == 4 and op.per_stream == 1024
        xs = tuple(
            jnp.arange(op.per_stream, dtype=jnp.float32) + 10.0 * i
            for i in range(op.n_streams)
        )
        outs = op(xs)
        assert len(outs) == op.n_streams
        for x, out in zip(xs, outs):
            np.testing.assert_allclose(np.asarray(out), np.asarray(x) + 1.0)
        assert op.bytes_per_call == 2 * op.n_elems * 4


class TestSweep:
    def test_core_candidates(self):
        assert compute_core_candidates(8, available=8) == [1, 2, 4, 8]
        assert compute_core_candidates(6, available=8) == [1, 2, 4, 6]
        assert compute_core_candidates(1, available=8) == [1]
        assert compute_core_candidates(16, available=8) == [1, 2, 4, 8]

    def test_tiny_sweep_end_to_end(self, tmp_path):
        cfg = BenchConfig(
            warmup=1, steps=2, matrix_size=128, matrix_depth=2,
            conv_size=16, batch_size=2, max_cores=2,
        )
        msgs = []
        results = run_sweep(cfg, log=msgs.append)
        tests_seen = {r["test"] for r in results}
        assert {"2D", "3D", "Conv", "2D_FFT", "3D_FFT", "Bandwidth"} <= tests_seen
        cores_seen = {r["cores"] for r in results}
        assert cores_seen == {1, 2}
        for r in results:
            assert r["avg_ms"] > 0
        # roofline columns: XLA-counted FLOPs next to the reference formulas
        # (cores=1 rows; backend-dependent, but CPU cost_analysis provides them)
        matmul_1core = [r for r in results if r["test"] == "2D" and r["cores"] == 1]
        assert matmul_1core and "xla_tflops" in matmul_1core[0]

        # export + plot round trip
        from jax_tpus_benchmark_physics_simulation_tpu.report.export import write_csv
        from jax_tpus_benchmark_physics_simulation_tpu.report.plots import (
            plot_benchmark_results,
        )

        csv_path = str(tmp_path / "results.csv")
        write_csv(results, csv_path)
        assert os.path.getsize(csv_path) > 0
        plot = plot_benchmark_results(results, str(tmp_path / "bench.png"))
        assert plot and os.path.getsize(plot) > 0

    def test_ops_filter_and_csv_append(self, tmp_path):
        """--ops runs a subset; --csv-append merges a second run into the
        same CSV."""
        base = dict(warmup=0, steps=1, matrix_size=64, matrix_depth=2,
                    conv_size=16, batch_size=2, max_cores=1)
        main = run_sweep(BenchConfig(ops=("2D", "Bandwidth"), **base),
                         log=lambda m: None)
        assert {r["test"] for r in main} == {"2D", "Bandwidth"}
        quarantine = run_sweep(BenchConfig(ops=("3D_FFT",), **base),
                               log=lambda m: None)
        assert {r["test"] for r in quarantine} == {"3D_FFT"}

        import pytest

        with pytest.raises(ValueError, match="unknown ops"):
            run_sweep(BenchConfig(ops=("4D",), **base), log=lambda m: None)

        from jax_tpus_benchmark_physics_simulation_tpu.report.export import write_csv

        path = str(tmp_path / "split.csv")
        write_csv(main, path)
        write_csv(quarantine, path, append=True)
        import csv as csv_mod

        with open(path, newline="") as f:
            rows = list(csv_mod.DictReader(f))
        assert [r["test"] for r in rows] == ["2D", "Bandwidth", "3D_FFT"]
        assert all(float(r["avg_ms"]) > 0 for r in rows)

    def test_divisibility_gate(self):
        cfg = BenchConfig(warmup=0, steps=1, matrix_size=64, matrix_depth=3, max_cores=2)
        msgs = []
        results = run_sweep(cfg, log=msgs.append)
        assert not any(r["test"] == "3D" and r["cores"] == 2 for r in results)
        assert any(r["test"] == "3D" and r["cores"] == 1 for r in results)


def test_system_info():
    info = system_info()
    assert info["backend"] == "cpu"
    assert info["device_count"] == 8

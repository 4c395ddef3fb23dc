"""Loud exits and recorded context of the CLI and benchmark layers: a flagged
overflow or a failed benchmark row ends in a non-zero exit status, matmul
rows state their precision, and records name the card. Fast (no MD run)."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from jax_tpus_benchmark_physics_simulation_tpu import cli
from jax_tpus_benchmark_physics_simulation_tpu.bench import runners, sysinfo
from jax_tpus_benchmark_physics_simulation_tpu.core.config import (
    BenchConfig,
    MDConfig,
    override,
)
from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid


def _fake_md_result(overflow):
    n, dim = 8, 2
    return lj_fluid.MDResult(
        state=None,
        r_history=jnp.zeros((2, n, dim)),
        ke_history=jnp.ones((2,)),
        pe_history=-2.0 * jnp.ones((2,)),
        rdf_r=jnp.zeros((3,)),
        rdf_g=jnp.zeros((3,)),
        time_eq_s=0.1,
        time_prod_s=0.1,
        time_rdf_s=0.01,
        overflow=overflow,
    )


@pytest.mark.parametrize("overflow,rc", [(True, 1), (False, 0)])
def test_md_exit_status_follows_overflow(monkeypatch, overflow, rc):
    monkeypatch.setattr(lj_fluid, "run", lambda cfg, **kw: _fake_md_result(overflow))
    argv = ["md", "--N", "8", "--eq_steps", "1", "--prod_steps", "2",
            "--sample_every", "1", "--output", "", "--manifest", ""]
    assert cli.main(argv) == rc


@pytest.mark.parametrize(
    "rows,rc",
    [
        ([{"test": "2D", "cores": 1, "avg_ms": 1.0, "precision": "float32"}], 0),
        ([{"test": "2D", "cores": 1, "avg_ms": 1.0},
          {"test": "3D_FFT", "cores": 1, "error": "RuntimeError: boom"}], 1),
    ],
)
def test_bench_exit_status_follows_error_rows(monkeypatch, tmp_path, rows, rc):
    import jax_tpus_benchmark_physics_simulation_tpu.bench as bench_pkg

    monkeypatch.setattr(bench_pkg, "run_sweep", lambda cfg, log=print: rows)
    manifest = tmp_path / "b.json"
    argv = ["bench", "--no-plot", "--manifest", str(manifest)]
    assert cli.main(argv) == rc
    assert json.loads(manifest.read_text())["results"]["results"] == rows


def test_failed_op_is_an_error_row():
    ctx = runners.BenchContext(BenchConfig(steps=1, warmup=0, repeats=1), log=lambda m: None)

    def alloc():
        raise RuntimeError("bad shape")

    row = runners._run_op(ctx, "2D", 1, lambda a: a, alloc)
    assert row["test"] == "2D" and "bad shape" in row["error"]


def test_precision_labels():
    f32 = runners.BenchContext(BenchConfig(precision="float32"))
    bf16 = runners.BenchContext(BenchConfig(precision="bfloat16"))
    assert runners.precision_label(bf16, matmul=True) == "bfloat16"
    assert runners.precision_label(f32, matmul=False) == "float32"
    assert runners.precision_label(f32, matmul=True).startswith("float32 (")
    import jax

    with jax.default_matmul_precision("highest"):
        assert runners.precision_label(f32, matmul=True) == "float32 (highest)"


def test_card_name_absent_off_gpu(tmp_path):
    info = sysinfo.system_info()
    assert info["backend"] == "cpu" and "gpu_name_power_limit" not in info
    from jax_tpus_benchmark_physics_simulation_tpu.report.manifest import write_manifest

    path = write_manifest(str(tmp_path / "m.json"), "x", BenchConfig(), {})
    doc = json.loads(open(path).read())
    assert "gpu_name_power_limit" in doc and doc["gpu_name_power_limit"] is None


class TestAutoSkin:
    def test_2d_keeps_default_on_one_device(self):
        cfg = override(MDConfig(), n=1_000_000, dim=2, cutoff=2.5)
        assert lj_fluid.resolve_skin(cfg, "grid", n_devices=1) == lj_fluid.SKIN_DEFAULT

    @pytest.mark.parametrize("dim", [2, 3])
    def test_rows_divide_the_mesh(self, dim):
        cfg = override(MDConfig(), n=1_000_000, dim=dim, cutoff=2.5)
        skin = lj_fluid.resolve_skin(cfg, "grid", n_devices=4)
        cps = int(cfg.box_size / (cfg.cutoff + skin) + 1e-9)
        assert cps % 4 == 0 and skin >= 0.1
        if dim == 2:
            assert skin >= lj_fluid.SKIN_DEFAULT  # never thinner than 0.4

    def test_3d_densest_geometry(self):
        cfg = override(MDConfig(), n=100_000, dim=3, cutoff=2.5)
        skin = lj_fluid.resolve_skin(cfg, "grid", n_devices=1)
        assert 0.1 <= skin < lj_fluid.SKIN_DEFAULT
        assert np.isclose(cfg.box_size / (cfg.cutoff + skin), 19.0)

"""Cell-grid force implementations (ops/kernels/cell_force.py, cell_triton.py)
against the dense oracle and each other, the choice of implementation, and
the environment helpers the main path depends on. All CPU; the Triton
kernel runs in the Pallas interpreter."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax_tpus_benchmark_physics_simulation_tpu.ops.forces import LennardJones
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels import cell_force
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_dense import (
    make_cell_grid_fn,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.cell_force import (
    choose_impl,
    fold_reactions,
    half_shell,
    lane_shift,
    make_grid_force,
    next_rows,
)
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md import GridMD
from jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3 import GridMD3
from tests.helpers import lattice_positions

REPO = Path(__file__).resolve().parents[1]
# N ~ 500 at densities that give >= 3 cells per side in both dimensions
SIZES = {2: (500, 0.8), 3: (500, 0.25)}


def grid_state(dim, seed=0):
    n, rho = SIZES[dim]
    box = (n / rho) ** (1.0 / dim)
    pos = jnp.mod(lattice_positions(n, box, dim=dim, jitter=0.1, seed=seed), box)
    gf = make_cell_grid_fn(box, 2.5, n, dim=dim)
    assert gf.cells_per_side >= 3
    md = (GridMD if dim == 2 else GridMD3)(gf)
    gs = md.init(pos, jnp.zeros_like(pos))
    coords = [gs.xg, gs.yg] + ([gs.zg] if dim == 3 else [])
    return box, pos, gf, md, gs, coords


def per_particle(md, grids, pid):
    pid = np.asarray(pid).reshape(-1)
    out = np.zeros((md.n, len(grids)))
    live = pid >= 0
    for c, g in enumerate(grids):
        out[pid[live], c] = np.asarray(g).reshape(-1)[live]
    return out


class TestPlainAgainstDenseOracle:
    @pytest.mark.parametrize("dim", [2, 3])
    def test_forces(self, dim):
        box, pos, gf, md, gs, coords = grid_state(dim)
        f = make_grid_force(gf, impl="plain")(*coords)
        f_ref = np.asarray(LennardJones(box=box, cutoff=2.5).force(pos))
        f_grid = per_particle(md, f, gs.pid)
        np.testing.assert_allclose(f_grid, f_ref, atol=1e-4 * np.abs(f_ref).max())

    @pytest.mark.parametrize("dim", [2, 3])
    def test_energy_and_virial(self, dim):
        box, pos, gf, md, gs, coords = grid_state(dim)
        out = make_grid_force(gf, impl="plain", with_energy=True)(*coords)
        lj = LennardJones(box=box, cutoff=2.5)
        np.testing.assert_allclose(
            0.5 * float(jnp.sum(out[dim])), float(lj.energy(pos)), rtol=1e-5
        )
        # virial reference: the dense sum over pairs of r.f = 24(2 s12 - s6)
        dr = pos[:, None, :] - pos[None, :, :]
        dr = dr - box * jnp.round(dr / box)
        r2 = jnp.sum(dr * dr, -1)
        mask = (r2 < 6.25) & ~jnp.eye(pos.shape[0], dtype=bool)
        s6 = jnp.where(mask, 1.0 / r2, 0.0) ** 3
        w_ref = 0.5 * float(jnp.sum(jnp.where(mask, 24.0 * (2 * s6 * s6 - s6), 0.0)))
        np.testing.assert_allclose(0.5 * float(jnp.sum(out[dim + 1])), w_ref, rtol=1e-5)

    @pytest.mark.parametrize("dim", [2, 3])
    def test_raw_contract_folds_to_totals(self, dim):
        """``.raw`` on the full grid with explicit next rows, reactions
        folded by the caller, equals the fused call."""
        box, pos, gf, md, gs, coords = grid_state(dim)
        f = make_grid_force(gf, impl="plain")
        args = []
        for c, v in enumerate(coords):
            args += [v, next_rows(v, box if c == 0 else 0.0)]
        out = fold_reactions(f.raw(*args), dim, with_energy=False)
        for a, b in zip(out, f(*coords)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


class TestTritonKernelInterpreted:
    @pytest.mark.parametrize("dim", [2, 3])
    def test_matches_plain(self, dim):
        box, pos, gf, md, gs, coords = grid_state(dim, seed=3)
        mo = gs.max_occ if dim == 3 else None
        plain = make_grid_force(gf, impl="plain", with_energy=True)(*coords)
        kern = make_grid_force(gf, impl="triton", interpret=True, with_energy=True)(
            *coords, max_occ=mo
        )
        fmax = max(float(jnp.max(jnp.abs(f))) for f in plain[:dim])
        for a, b in zip(kern[:dim], plain[:dim]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5 * fmax)
        for k in (dim, dim + 1):  # energy, virial
            np.testing.assert_allclose(
                float(jnp.sum(kern[k])), float(jnp.sum(plain[k])), rtol=1e-6
            )

    def test_raw_matches_plain_raw_3d(self):
        """The sharded engines' contract: local rows with explicit halo
        rows, unshifted reactions."""
        box, pos, gf, md, gs, coords = grid_state(3, seed=5)
        args = []
        for c, v in enumerate(coords):
            args += [v, next_rows(v, box if c == 0 else 0.0)]
        plain = make_grid_force(gf, impl="plain").raw(*args)
        kern = make_grid_force(gf, impl="triton", interpret=True).raw(
            *args, max_occ=gs.max_occ
        )
        fmax = max(float(jnp.max(jnp.abs(f))) for f in plain)
        for a, b in zip(kern, plain):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5 * fmax)


class TestChoice:
    def test_cpu_builds_plain(self):
        assert choose_impl() == "plain"
        _, _, gf, md, _, _ = grid_state(2)
        assert md.force_kernel.impl == "plain" and md.energy_kernel.impl == "plain"

    def test_platform_table(self):
        assert choose_impl("gpu") == cell_force.GPU_IMPL == "triton"
        assert choose_impl("cpu") == "plain"

    def test_kernel_without_interpret_raises_off_gpu(self):
        _, _, gf, _, _, _ = grid_state(2)
        with pytest.raises(ValueError, match="needs a GPU"):
            make_grid_force(gf, impl="triton")
        with pytest.raises(ValueError, match="unknown force impl"):
            make_grid_force(gf, impl="pallas")

    def test_layout_is_unpadded(self):
        _, _, gf, md, gs, _ = grid_state(3)
        cps = gf.cells_per_side
        assert md.grid_shape == (cps, gf.capacity, cps * cps)
        assert gs.xg.shape == md.grid_shape
        assert gf.capacity % 8 == 0  # whole 8-slot kernel tiles

    def test_half_shell_covers_each_pair_once(self):
        for k in (1, 2):
            same, nxt = half_shell(k)
            assert len(nxt) == 3**k
            # same-row offsets and their negatives tile the nonzero offsets
            assert sorted(same + [tuple(-d for d in o) for o in same]) == sorted(
                o for o in nxt if any(o)
            )

    def test_lane_shift_seam(self):
        v = jnp.arange(12.0).reshape(1, 1, 12)  # lanes of a (3, 4) plane
        out = np.asarray(lane_shift(v, (1, 0), (3, 4), coord_axis=0, box=100.0))
        plane = np.arange(12.0).reshape(3, 4)
        want = np.roll(plane, -1, axis=0)
        want[-1] += 100.0  # wrapped cells sit one box further on
        np.testing.assert_array_equal(out.reshape(3, 4), want)


class TestDenseOracleBlocks:
    def test_force_on_matches_dense(self):
        box = 12.0
        pos = jnp.mod(lattice_positions(300, box, dim=3, jitter=0.2, seed=2), box)
        lj = LennardJones(box=box, cutoff=2.5)
        idx = jnp.array([0, 17, 150, 299])
        got = np.asarray(lj.force_on(pos, idx, block=64))
        want = np.asarray(lj.force(pos))[np.asarray(idx)]
        np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


class TestEnvironment:
    def test_cache_dir_follows_env(self, monkeypatch):
        from jax_tpus_benchmark_physics_simulation_tpu.utils import cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
        assert cache.cache_dir() is None
        assert cache.enable_compilation_cache() == "/some/where"
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert cache.cache_dir() == str(REPO / ".jax_cache")
        # CPU runs set nothing (the config would leak across tests)
        assert "CPU" in cache.enable_compilation_cache()

    def test_struct_helper(self):
        from jax_tpus_benchmark_physics_simulation_tpu.utils import struct

        @struct.dataclass
        class S:
            a: jax.Array
            n: int = struct.field(pytree_node=False, default=3)
            b: object = None

        s = S(a=jnp.ones(2), b=jnp.zeros(1))
        leaves, tree = jax.tree.flatten(s)
        assert len(leaves) == 2  # n is static
        s2 = jax.tree.unflatten(tree, [x + 1 for x in leaves])
        assert s2.n == 3 and float(s2.a[0]) == 2.0
        s3 = s2.replace(n=5)
        assert s3.n == 5 and s2.n == 3
        with pytest.raises(Exception):
            s.a = 1  # frozen
        out = jax.jit(lambda t: t.replace(a=t.a * t.n))(s)
        assert float(out.a[0]) == 3.0

    def test_main_path_imports_without_flax_or_matplotlib(self):
        code = (
            "import sys; sys.modules['flax'] = None; sys.modules['matplotlib'] = None\n"
            "import jax_tpus_benchmark_physics_simulation_tpu.models.lj_fluid\n"
            "import jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md\n"
            "import jax_tpus_benchmark_physics_simulation_tpu.ops.kernels.grid_md3\n"
            "import jax_tpus_benchmark_physics_simulation_tpu.cli\n"
        )
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert r.returncode == 0, r.stderr[-2000:]

    def test_workloads_run_without_matplotlib(self):
        """Every workload the GPU check drives runs with plotting off and
        matplotlib absent (it is not installed on every machine)."""
        code = (
            "import sys; sys.modules['matplotlib'] = None\n"
            "from jax_tpus_benchmark_physics_simulation_tpu import cli\n"
            "runs = [\n"
            " ['md', '--N', '64', '--eq_steps', '4', '--prod_steps', '4',\n"
            "  '--sample_every', '2', '--init', 'lattice', '--output', '', '--manifest', ''],\n"
            " ['nbody', '--num_steps', '5', '--sim_time', '1', '--no-media', '--no-chaos', '--manifest', ''],\n"
            " ['em3', '--n_steps', '5', '--no-media', '--manifest', ''],\n"
            " ['vmc', '--n_walkers', '32', '--n_epochs', '2', '--n_equil', '2', '--n_dmc', '2',\n"
            "  '--dim', '1', '--no-gif', '--no-plot', '--manifest', ''],\n"
            " ['bench', '--ops', '2D', '-mxs', '16', '-m', '1', '-w', '0', '-r', '1', '--no-plot',\n"
            "  '--max_cores', '1', '--manifest', ''],\n"
            "]\n"
            "for argv in runs:\n"
            "    assert cli.main(argv) == 0, argv\n"
        )
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 0, r.stderr[-3000:]

    def test_chip_smoke_refuses_cpu(self):
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run(
            [sys.executable, "chip_smoke.py"], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert r.returncode != 0
        assert "needs an NVIDIA GPU" in r.stderr
        assert '"ok"' not in r.stdout

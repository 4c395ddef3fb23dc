"""Cross-implementation MD consistency: dense XLA vs grid vs neighbor-list
paths must produce the same trajectories and conserve energy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from jax_tpus_benchmark_physics_simulation_tpu.core.config import MDConfig, override
from jax_tpus_benchmark_physics_simulation_tpu.models import lj_fluid


def cfg_for(impl, **kw):
    base = dict(
        n=100,
        rho=0.6,
        eq_steps=50,
        prod_steps=100,
        sample_every=10,
        init="lattice",
        cutoff=2.5,
        force_impl=impl,
        dt=1e-3,
    )
    base.update(kw)
    return override(MDConfig(), **base)


@pytest.mark.parametrize("impl", ["grid", "neighbor"])
def test_trajectory_matches_dense_xla(impl):
    cfg_ref = cfg_for("dense_xla")
    cfg_alt = cfg_for(impl)
    state = lj_fluid.init_state(cfg_ref)

    s_ref, ovf_r = lj_fluid.equilibrate(cfg_ref, state)
    s_alt, ovf_a = lj_fluid.equilibrate(cfg_alt, state)
    assert not bool(ovf_r) and not bool(ovf_a)
    np.testing.assert_allclose(
        np.asarray(s_alt.position), np.asarray(s_ref.position), rtol=1e-3, atol=1e-3
    )


@pytest.mark.parametrize("impl", ["dense_xla", "neighbor"])
def test_energy_conservation(impl):
    cfg = cfg_for(impl, eq_steps=200, prod_steps=1000, sample_every=25, dt=5e-4)
    res = lj_fluid.run(cfg)
    assert res.energy_drift < 5e-3, (impl, res.energy_drift)


def test_neighbor_energy_matches_dense_energy_observable():
    cfg_n = cfg_for("neighbor")
    cfg_d = cfg_for("dense_xla")
    state = lj_fluid.init_state(cfg_n)
    _, (_, ke_n, pe_n), _ = lj_fluid.production(cfg_n, state)
    _, (_, ke_d, pe_d), _ = lj_fluid.production(cfg_d, state)
    np.testing.assert_allclose(np.asarray(pe_n), np.asarray(pe_d), rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(np.asarray(ke_n), np.asarray(ke_d), rtol=1e-3, atol=1e-2)

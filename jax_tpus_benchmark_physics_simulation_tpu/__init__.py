"""JAX particle-simulation + benchmark framework.

A ground-up re-design of the capabilities of
``ThemeHackers/jax_tpus_benchmark_physics_simulation`` (five standalone
single-host JAX scripts) as one engine:

- ``core``     state pytrees, typed configs, fused scan runners
- ``ops``      force fields, integrators, observables, force kernels
- ``mc``       Metropolis / VMC / DMC Monte Carlo engines
- ``models``   the five reference workloads as thin configs on the engine
- ``parallel`` device mesh, shard_map ring force pass, collectives
- ``bench``    op benchmark suite (matmul/FFT/conv/bandwidth, mesh sweep)
- ``report``   rich console, CSV/JSON export, plots, GIF/WAV media
- ``ckpt``     orbax checkpoint/resume of engine state
"""

__version__ = "0.1.0"

from jax_tpus_benchmark_physics_simulation_tpu.core.state import (  # noqa: F401
    ParticleState,
    WalkerState,
)

"""Typed configuration layer shared by all workloads.

The reference has four inconsistent argparse blocks plus interactive rich
prompts (SURVEY.md §5 "Config / flag system"): tpus_benchmark...:28-39,
molecular_dynamics...:194-215, three_particles...:9-17, vmc_dmc...:348-360,
nbody...:29-39. Defaults below mirror the reference's *code* defaults
(where README and code disagree — README.md:119 vs tpus_benchmark...:30-32 —
the code wins, documented in SURVEY.md §6).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MDConfig:
    """2D Lennard-Jones fluid (reference: molecular_dynamics...:13-31)."""

    n: int = 400
    rho: float = 0.8
    kt: float = 1.0
    dt: float = 1e-3
    eq_steps: int = 10_000
    prod_steps: int = 10_000
    sample_every: int = 100
    seed: int = 42
    dim: int = 2
    sigma: float = 1.0
    epsilon: float = 1.0
    # Extensions (absent in reference):
    cutoff: Optional[float] = None  # None = full O(N^2) like the reference
    force_impl: str = "auto"  # auto | dense_xla | neighbor | cell | grid
    dtype: str = "float32"
    rdf_dr: float = 0.05  # molecular_dynamics...:157
    init: str = "uniform"  # uniform (reference, molecular_dynamics...:134) | lattice
    remove_com_drift: bool = False  # reference never removes COM drift
    # Verlet skin. None = auto (lj_fluid.resolve_skin): 0.4 for the 2D/list
    # paths; the 3D grid engine picks the DENSEST cell geometry with skin
    # >= ~0.1. An explicit float pins the geometry everywhere.
    skin: Optional[float] = None
    # Kahan-compensated integration (grid path): kills the f32 secular energy
    # drift (measured 7.3e-3 -> ~1e-6 over 1M steps at N=100k) for ~25% step
    # cost. Default on: correctness first.
    compensated: bool = True
    # NVT ensemble (grid path): "langevin" runs BAOAB Langevin windows at
    # temperature ``kt`` through equilibration AND production (the reference
    # is NVE-only and large lattice melts transiently exceed the kt=1 skin
    # sizing — the thermostat pins kT so 1M-particle runs equilibrate
    # without tripping the violation gate). "none" = NVE (reference
    # behavior).
    thermostat: str = "none"  # none | langevin
    gamma: float = 1.0  # Langevin friction (1/time units)

    @property
    def box_size(self) -> float:
        return (self.n / self.rho) ** (1.0 / self.dim)


@dataclass(frozen=True)
class NBodyConfig:
    """N-body BH merger (reference interactive prompts nbody...:29-39)."""

    n_bodies: int = 3
    masses: tuple = (30.0, 30.0, 30.0)
    initial_distance: float = 100.0
    initial_velocity: float = 0.1
    sim_time: float = 200.0
    d_gw_mpc: float = 410.0
    num_steps: int = 1000  # hardcoded at nbody...:113
    compute_chaos: bool = True
    g: float = 1.0
    c: float = 1.0
    # Extensions beyond the reference:
    lyapunov_method: str = "tangent"  # tangent (variational) | two_trajectory (reference)
    integrator: str = "rk4"  # rk4 (reference) | dopri5 (adaptive)
    rtol: float = 1e-6  # dopri5 tolerances
    atol: float = 1e-9


@dataclass(frozen=True)
class EM3Config:
    """Three-particle gravity + non-uniform EM (three_particles...:9-17)."""

    dt: float = 0.01
    n_steps: int = 1000
    g: float = 1.0
    bz: float = 1.0
    bk: float = 0.0
    ex: float = 0.0
    ey: float = 0.0
    # Extension: Boris push handles velocity-dependent magnetic
    # force correctly; "reference" reproduces the reference's pseudo-Verlet
    # (three_particles...:69-76, documented there as improper for B-fields).
    integrator: str = "boris"


@dataclass(frozen=True)
class VMCDMCConfig:
    """VMC/DMC quantum harmonic oscillator (vmc_dmc...:347-361)."""

    n_walkers: int = 10_000
    n_epochs: int = 3000
    n_equil: int = 100
    step_size: float = 2.0
    lr: float = 0.02
    n_dmc: int = 500
    dmc_dt: float = 0.01
    dim: int = 3
    seed: int = 42
    alpha_init: float = 1.0
    alpha_min: float = 0.01  # clamp at vmc_dmc...:94
    # Extensions beyond the reference:
    resampler: str = "systematic"  # systematic | multinomial (reference)
    epoch_chunk: int = 50  # epochs fused per device program (scan length)
    snapshot_every: int = 0  # 0 = no walker snapshots; >0 for GIF frames
    prng_impl: str = "auto"  # auto (threefry2x32) | threefry | rbg
    # potential: harmonic (reference) | anharmonic (V += lam*sum x^4, generic
    # autodiff local energy + pytree {alpha, beta} trial — beyond reference)
    potential: str = "harmonic"
    lam: float = 0.2  # quartic coupling for potential="anharmonic"


@dataclass(frozen=True)
class BenchConfig:
    """Op benchmark suite (tpus_benchmark...:28-47).

    ``warmup`` means warmup (untimed executions of the fused timing loop;
    one execution covers ``steps`` op iterations, so warmup=1 already exceeds
    the reference's 10 warmup iterations at :29/:207-208). ``repeats`` is the
    number of timed executions (best-of) — a separate flag, unlike round 1
    which repurposed warmup as the repeat count.

    Conv defaults: the reference defines but never runs its conv
    (tpus_benchmark...:141-155, cin=3); at its 8x64x64x3 shape the op is
    dispatch-latency-bound and cin=3 leaves the matrix units nearly idle.
    Since there is no reference number to match, the default
    problem is sized compute-bound (64x128x128x32 -> 64, ~39 GFLOP/call);
    the analytic formula (flops.conv_flops) is exact for SAME/stride-1.
    """

    warmup: int = 1
    repeats: int = 3
    steps: int = 2500
    matrix_size: int = 4096
    matrix_depth: int = 6
    conv_size: int = 128
    batch_size: int = 64
    conv_cin: int = 32
    conv_cout: int = 64
    precision: str = "float32"  # float32 | bfloat16
    max_cores: int = 0  # 0 = auto up to available
    # None = all ops; else case-insensitive op names to run (e.g.
    # ("2D", "Bandwidth")).
    ops: Optional[Tuple[str, ...]] = None
    csv: Optional[str] = None
    plot: Optional[str] = "benchmark_results.png"


def override(cfg, **kwargs):
    """Return a copy of a frozen config with fields replaced."""
    valid = {f.name for f in dataclasses.fields(cfg)}
    bad = set(kwargs) - valid
    if bad:
        raise TypeError(f"unknown config fields for {type(cfg).__name__}: {sorted(bad)}")
    return dataclasses.replace(cfg, **kwargs)

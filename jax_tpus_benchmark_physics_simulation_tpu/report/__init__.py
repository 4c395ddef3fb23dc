"""Console tables, CSV/JSON export, plots and media. ``plots`` and ``media``
need matplotlib, so they load only when imported by name."""

from jax_tpus_benchmark_physics_simulation_tpu.report import console, export

__all__ = ["console", "export"]

"""Dependency verification (reference: utils/check_deps.py:47-106, minus the
NameError in its missing-lib error path at :103, and without sys.exit — the
caller decides)."""

from __future__ import annotations

import importlib
from typing import List, Tuple

REQUIRED_LIBRARIES = ["jax", "numpy", "optax"]
OPTIONAL_LIBRARIES = ["rich", "psutil", "matplotlib", "imageio", "scipy", "orbax.checkpoint"]


def probe(libs: List[str]) -> List[Tuple[str, bool]]:
    out = []
    for lib in libs:
        try:
            importlib.import_module(lib)
            out.append((lib, True))
        except ImportError:
            out.append((lib, False))
    return out


def check_dependencies(verbose: bool = True) -> bool:
    """Returns True iff all required libraries import. Never exits."""
    from jax_tpus_benchmark_physics_simulation_tpu.report import console

    required = probe(REQUIRED_LIBRARIES)
    optional = probe(OPTIONAL_LIBRARIES)
    if verbose:
        console.records_table(
            "Dependency Check",
            [
                {"library": n, "required": "yes", "status": "ok" if ok else "MISSING"}
                for n, ok in required
            ]
            + [
                {"library": n, "required": "no", "status": "ok" if ok else "missing"}
                for n, ok in optional
            ],
            ["library", "required", "status"],
        )
    missing = [n for n, ok in required if not ok]
    if missing and verbose:
        console.log(f"missing required libraries: {', '.join(missing)}")
    return not missing

"""Run manifest: one JSON per workload run capturing what ran, where, and
what came out (SURVEY.md §7 step 9's report plan — config + git rev + device
+ results). The reference records nothing about a run but its final plots;
a manifest makes every run attributable and reproducible.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, Optional


def _git_rev() -> Optional[str]:
    try:
        return (
            subprocess.run(
                ["git", "rev-parse", "HEAD"],
                capture_output=True,
                text=True,
                timeout=5,
                cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
            ).stdout.strip()
            or None
        )
    except Exception:
        return None


def _devices() -> list:
    try:
        import jax

        return [
            {"id": d.id, "kind": d.device_kind, "platform": d.platform}
            for d in jax.devices()
        ]
    except Exception:
        return []


def _gpu() -> Optional[str]:
    """nvidia-smi ``name, power.limit`` beside ``device_kind`` (None off GPU)."""
    try:
        import jax

        if jax.default_backend() != "gpu":
            return None
        from jax_tpus_benchmark_physics_simulation_tpu.bench.sysinfo import (
            gpu_name_and_power_limit,
        )

        return gpu_name_and_power_limit()
    except Exception:
        return None


def _jsonable(v: Any):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {f.name: _jsonable(getattr(v, f.name)) for f in dataclasses.fields(v)}
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:  # 0-d array
        return v.item()
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def write_manifest(
    path: str,
    workload: str,
    config: Any,
    results: Dict[str, Any],
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    """Write the run manifest JSON and return its path."""
    doc = {
        "workload": workload,
        "timestamp_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "argv": sys.argv,
        "git_rev": _git_rev(),
        "devices": _devices(),
        "gpu_name_power_limit": _gpu(),
        "config": _jsonable(config),
        "results": _jsonable(results),
    }
    if extra:
        doc.update(_jsonable(extra))
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    return path

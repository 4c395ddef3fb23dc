"""System / device introspection.

Reference: ``get_system_info`` (tpus_benchmark...:81-122), ``safe_device_count``
(:59-71) and ``utils/jax_devices.py`` (reproduced WITHOUT its import-time side
effects — the reference calls ``jax.devices()`` and prints a table at import,
jax_devices.py:10,31).
"""

from __future__ import annotations

import platform
import shutil
import subprocess
from typing import List, Optional

import jax


def gpu_name_and_power_limit() -> Optional[str]:
    """``name, power.limit`` of the first GPU as nvidia-smi prints them
    (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``), or None without nvidia-smi.
    A card set below its maximum power runs slower under load, so every
    saved number is recorded beside this line."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip()
    except Exception:
        return None
    return out.splitlines()[0] if out else None


def safe_device_count() -> int:
    try:
        return int(jax.device_count())
    except Exception:
        return 0


def device_rows() -> List[dict]:
    """One dict per JAX device (index/kind/id/process/platform)."""
    try:
        devices = jax.devices()
    except Exception:
        return []
    return [
        {
            "index": i,
            "device_kind": str(getattr(d, "device_kind", "unknown")),
            "id": d.id,
            "process_index": getattr(d, "process_index", 0),
            "platform": d.platform,
        }
        for i, d in enumerate(devices)
    ]


def system_info() -> dict:
    info = {
        "os": f"{platform.system()} {platform.release()}",
        "machine": platform.machine(),
        "python": platform.python_version(),
        "jax": jax.__version__,
    }
    try:
        import psutil

        info["cpu_logical"] = psutil.cpu_count(logical=True)
        info["cpu_physical"] = psutil.cpu_count(logical=False)
        info["ram_gb"] = round(psutil.virtual_memory().total / 1024**3, 2)
    except Exception:
        pass
    try:
        devices = jax.devices()
        info["backend"] = jax.default_backend()
        info["device_count"] = len(devices)
        info["device_kind"] = str(getattr(devices[0], "device_kind", "unknown"))
        gpu = gpu_name_and_power_limit() if info["backend"] == "gpu" else None
        if gpu:
            info["gpu_name_power_limit"] = gpu
        mem = getattr(devices[0], "memory_stats", lambda: None)()
        if mem and "bytes_limit" in mem:
            info["device_memory_gb"] = round(mem["bytes_limit"] / 1024**3, 2)
    except Exception as e:
        info["backend"] = f"unavailable ({e})"
    return info

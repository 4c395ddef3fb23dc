"""Result export: CSV (union-of-keys schema), JSON, WAV audio.

Reference: CSV export tpus_benchmark...:708-721 (same fieldname union
semantics), JSON dump nbody...:284-287, GW audio WAV nbody...:220-227
(same normalize -> 5x boost -> clip -> int16 pipeline).
"""

from __future__ import annotations

import csv
import json
import os
from typing import List, Sequence

import numpy as np


def write_csv(results: List[dict], path: str, append: bool = False) -> None:
    """Union-of-keys fieldnames, blank for missing (reference :710-717).

    ``append=True`` reuses an existing file's header (extra keys in the new
    rows are dropped to keep the columns aligned) so a sweep split across
    runs lands in one file."""
    if not results:
        return
    existing_header = None
    if append and os.path.exists(path):
        with open(path, newline="", encoding="utf-8") as f:
            existing_header = next(csv.reader(f), None)
    if existing_header:
        fieldnames = existing_header
        mode = "a"
    else:
        fieldnames = sorted(set().union(*(r.keys() for r in results)))
        mode = "w"
    with open(path, mode, newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=fieldnames, extrasaction="ignore")
        if mode == "w":
            writer.writeheader()
        for r in results:
            writer.writerow({k: r.get(k, "") for k in fieldnames})


def write_json(data, path: str) -> None:
    def default(o):
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.floating, np.integer)):
            return o.item()
        return str(o)

    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, default=default)


def write_wav(signal: Sequence[float], path: str, sample_rate: int = 44100, boost: float = 5.0) -> None:
    """Normalized, boosted, clipped int16 WAV (reference nbody...:220-227)."""
    try:
        from scipy.io import wavfile
    except ImportError as e:  # pragma: no cover - environment-dependent
        raise ImportError(
            "WAV output requires scipy; install the extra: "
            "pip install 'jax_tpus_benchmark_physics_simulation_tpu[media]'"
        ) from e

    sig = np.asarray(signal, dtype=np.float64)
    normalized = sig / (np.max(np.abs(sig)) + 1e-10)
    clipped = np.clip(normalized * boost, -1.0, 1.0)
    wavfile.write(path, sample_rate, np.int16(clipped * 32767))

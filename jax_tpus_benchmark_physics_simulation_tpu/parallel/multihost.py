"""Multi-host initialization.

The reference is single-host by construction (every script is titled
"single-host", SURVEY.md §2g). The engine's mesh/ring machinery is
host-count-agnostic: on a multi-host slice, call :func:`init_multihost` first
and build the mesh over ``jax.devices()`` (global); GSPMD compiles the ring
ppermute onto ICI within the slice and DCN across slices.

Exercised for real (not just wrapped) by tests/test_multihost.py: a
2-process CPU cluster via ``jax.distributed`` that runs a psum across
processes and the sharded-MD halo machinery on the global mesh.
"""

from __future__ import annotations

from typing import Optional


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[list] = None,
) -> bool:
    """Initialize jax.distributed. Returns True when distributed mode is
    active with more than one process.

    With no arguments, relies on the launcher environment (cluster
    auto-detection); a ``RuntimeError`` from double initialization is tolerated
    (idempotent use), but genuine failures — bad coordinator address,
    mismatched process counts — PROPAGATE: swallowing them (round-1 behavior)
    turned a misconfigured cluster into a silent single-host run.
    """
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    except RuntimeError as e:
        if "already" in str(e).lower():  # initialized twice: idempotent no-op
            return jax.process_count() > 1
        if coordinator_address is None and num_processes is None:
            # auto-detect on a plain single host finds no cluster: not an error
            return False
        raise
    return jax.process_count() > 1


def is_primary() -> bool:
    """True on the process that should write artifacts/logs."""
    import jax

    return jax.process_index() == 0

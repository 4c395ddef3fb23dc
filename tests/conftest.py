"""Test harness: run everything on a virtual 8-device CPU mesh.

The reference's pmap paths were never tested (SURVEY.md §4). Here
multi-device sharding is testable single-process via the standard JAX
trick: force 8 host-platform devices before JAX initializes.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# An installed accelerator plugin must not win over the CPU request; the
# config update is authoritative.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_threefry_partitionable", True)

assert jax.default_backend() == "cpu", jax.devices()
assert jax.device_count() == 8, jax.devices()

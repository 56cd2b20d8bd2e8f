"""Test configuration: CPU backend with 8 virtual devices.

Correctness oracles need native float64 (1e-8 Ha bar), so tests run on the
CPU backend; multi-device sharding tests use an 8-device virtual CPU mesh.
The GPU path is exercised by ``python chip_smoke.py``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pymes_jax  # noqa: E402,F401  (enables x64)

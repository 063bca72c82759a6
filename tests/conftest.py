"""Test environment: force the CPU backend with 8 virtual devices.

The tests run on the CPU even where a GPU is present: the jax config is
updated before any backend initializes. Multi-device sharding is validated
on the 8 virtual CPU devices (xla_force_host_platform_device_count), per
SURVEY §4: shard the same pileup 1-way vs N-way and assert identical
output. What only a GPU can run is checked by ``chip_smoke.py``.
"""

import os
import sys

# the repo root is importable: tools/ (the C++ baseline's build) and the
# top-level scripts
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", jax.devices()

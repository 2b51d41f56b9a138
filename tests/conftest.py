"""Test harness configuration.

Tests run hermetically on the CPU with 8 virtual XLA devices, so that the
sharding / multi-device code paths are exercised without accelerators
(the standard no-cluster multi-host harness, SURVEY.md §4).  The CPU is
forced so that results do not depend on which accelerator a machine has;
on-device checks live in chip_smoke.py.  Must run before jax imports.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

# jax reads JAX_PLATFORMS when it is first imported; if anything imported
# it before this file ran, the variable came too late and this still holds.
jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_enable_x64", False)
# Persistent compilation cache: the suite is compile-bound on CPU; cached
# executables make repeat runs fast.
from vslam_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

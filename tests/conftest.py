"""Test config: force an 8-device virtual CPU mesh so multi-device
sharding paths are exercised without accelerators (SURVEY.md §4
implication)."""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

# persistent compilation cache: the suite's dominant cost is first-time
# XLA compiles; repeat runs hit the cache
from coxgraph_tpu.utils import runtime  # noqa: E402

runtime.enable_compilation_cache()

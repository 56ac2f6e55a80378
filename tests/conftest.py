"""Test configuration.

Tests run on CPU with 8 virtual devices so multi-device sharding is
exercised without accelerator hardware (SURVEY.md §4c), and with x64
enabled so the float64 parity path (reference plugin precision,
foo_dsp_bfir/common.h:17) is testable.

The platform is forced with jax.config.update, which holds even when the
JAX_PLATFORMS environment variable names another platform. XLA_FLAGS is
honored lazily at first CPU-backend init. What only a GPU can run is
checked by ``python chip_smoke.py`` on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    # registered explicitly so plain pytest (no xdist) doesn't warn; under
    # pytest-xdist run with --dist loadgroup so the heavy sharded-session
    # tests share one worker (concurrent 8-device shard_map compiles have
    # aborted workers under 4-way contention)
    config.addinivalue_line(
        "markers",
        "xdist_group(name): serialize marked tests onto one xdist worker")

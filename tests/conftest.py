"""Test configuration.

Forces an 8-device virtual CPU platform so multi-device sharding logic is
exercised without accelerator hardware (SURVEY.md §4).  The platform is
pinned through the config as well as the environment, before any backend
is initialized, so an interpreter-start hook that sets jax_platforms
cannot route the tests elsewhere.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

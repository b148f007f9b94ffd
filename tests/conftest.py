"""Test configuration: every test runs on the CPU, with 8 virtual devices so
the multi-device sharding paths (parallel/) run without accelerators.

The platform is set through jax.config as well as the environment variable,
before any backend initializes, in case jax was imported earlier.
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
jax.config.update("jax_enable_x64", False)
assert jax.default_backend() == "cpu", "tests run on the CPU backend"
assert len(jax.devices()) == 8, "expected 8 virtual CPU devices"

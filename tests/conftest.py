"""Test harness config: the suite runs on the CPU backend with a virtual
8-device mesh, so every sharding path is exercised without a GPU
(SURVEY.md §4). Checks that need the card are phases of chip_smoke.py.
The platform is forced through the env var and the config API before any
jax usage.
"""

import os

# Must run before jax is imported anywhere.
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

assert jax.devices()[0].platform == "cpu", (
    f"tests must run on CPU, got {jax.devices()}"
)
assert jax.device_count() >= 8, "virtual 8-device mesh not active"

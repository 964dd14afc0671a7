"""Unit tests run on the CPU backend with 8 virtual devices, so the
multi-device logic is exercised without accelerators. The GPU path is
proven by chip_smoke.py, which must not import this file.

The CPU backend is forced through jax.config before any backend
initialization, whatever JAX_PLATFORMS says."""
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

"""Test configuration.

Tests run on CPU with float64 enabled (reproducing the reference's
ComplexF64 tolerance anchors) and with 8 virtual devices so the
multi-device sharding path can be exercised without a GPU.  The GPU is
exercised by ``python chip_smoke.py``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
for name, value in (
    ("xla_force_host_platform_device_count", "8"),
    # The CPU backend's in-process all-reduce aborts the whole process
    # when one participant arrives 40 s (the default) after the first.
    # With parallel test workers on a loaded host, one virtual device's
    # thread can be starved that long; a late participant is slow, not
    # stuck.
    ("xla_cpu_collective_call_terminate_timeout_seconds", "900"),
):
    if name not in flags:
        flags = f"{flags} --{name}={value}".strip()
os.environ["XLA_FLAGS"] = flags

import jax

# CPU tests even where the environment selects a GPU (JAX_PLATFORMS set)
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

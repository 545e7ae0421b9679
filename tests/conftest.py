"""Hermetic test defaults: CPU JAX with an 8-device virtual mesh.

Tests never touch an accelerator or the network; multi-device sharding is
validated on the virtual CPU mesh (the analogue of the reference's hand-rolled
fakes — reference test strategy: src/adapters/sources/test_fixtures.rs,
tests/analyze_flow.rs). Tests marked ``gpu`` need the card and skip here;
``python chip_smoke.py`` runs that path on a GPU.

JAX_PLATFORMS is force-overridden — setdefault is not enough when the
environment names another platform — and pinned again through jax.config.
"""

import os

# Must be set before jax initializes its backends.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

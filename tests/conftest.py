"""Test configuration.

The tier-1 run uses JAX's CPU backend with 8 virtual devices, so the
multi-device (``shard_map``) paths run here as well. XLA_FLAGS must be set
before JAX initializes its backends.

Tests marked ``gpu`` need an NVIDIA card; the ``gpu_device`` fixture skips
them elsewhere. ``chip_smoke.py`` runs that set on the card with
``DIAGON_TEST_DEVICE=gpu``, which leaves JAX on its default (GPU) backend.
"""

import os

import pytest

ON_CARD = os.environ.get("DIAGON_TEST_DEVICE") == "gpu"

if not ON_CARD:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first NVIDIA device; skips the test where there is none."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (python chip_smoke.py runs it)")
    return devs[0]

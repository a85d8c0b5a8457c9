"""Test configuration: run everything on a virtual 8-device CPU backend.

Tests exercise multi-device sharding on 8 fake CPU devices (SURVEY.md
§4c). The CPU backend is selected through ``jax.config`` right after the
jax import, before any computation runs. Tests that need the card are
marked ``gpu`` and skip here (the ``gpu`` fixture); run them on the GPU
with ``python -m pytest tests -m gpu``; ``python chip_smoke.py`` checks
the main path there end to end.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)

"""Test configuration.

Tests run on the CPU by default (JAX_PLATFORMS, when unset, is set to cpu
here) with 8 virtual devices, so the multi-device shard_map paths get real
coverage without a device mesh, and with x64 enabled so the float64
oracle/parity tests (Fortran fixtures need atol=1e-8) are meaningful.  The
library itself is dtype-parametric; the benchmarks run float32.

Tests marked ``gpu`` need a CUDA card and skip elsewhere; run them on one
with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`` (the CPU
backend stays listed for host callbacks).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The devices of a CUDA backend; skips the test without one (decided
    here, at run time, so every xdist worker collects the same tests)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu")
    return devices


FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")

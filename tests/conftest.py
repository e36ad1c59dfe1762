"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device hardware is not available in CI; sharding tests use the
standard JAX pattern of faking devices on the host platform.  Set
``QUBLAS_TEST_BACKEND`` to run the suite against a real backend instead
(e.g. ``QUBLAS_TEST_BACKEND=cuda``).

Tests of code that runs only on an NVIDIA GPU carry the ``gpu`` marker
(registered in pyproject.toml); the ``gpu_device`` fixture skips them, with
the reason, when the backend has no GPU.  The check runs inside the
fixture, never at import, so it is made in each xdist worker.
"""

import os

import pytest

backend = os.environ.get("QUBLAS_TEST_BACKEND", "cpu")
os.environ["JAX_PLATFORMS"] = backend
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", backend)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when the backend has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; the test backend is "
                    f"{dev.platform!r}")
    return dev

"""Test configuration: run on a faked 8-device CPU mesh by default.

Multi-device behaviour is testable without accelerators via XLA's
host-platform device-count override (SURVEY.md §4).  A ``JAX_PLATFORMS``
that is already set is respected, so ``JAX_PLATFORMS=cuda python -m
pytest -m gpu tests/`` runs the card's tests on the GPU.  Tests marked
``gpu`` take the ``gpu`` fixture, which decides at run time whether a
card is there.
"""

import os

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")

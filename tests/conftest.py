"""Test configuration: JAX on a virtual 8-device CPU mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu``; Pallas kernels in
interpret mode), exercising numerics and the multi-device sharding path
anywhere. ``AM_TEST_PLATFORM=gpu`` leaves the platform to JAX instead, for
the tests marked ``gpu`` (``python -m pytest tests/ -m gpu`` on a machine
with a card); whether a card is present is decided in the ``gpu_device``
fixture, never at import.
"""

import os
import re

if os.environ.get("AM_TEST_PLATFORM", "cpu") == "cpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
m = re.search(r"--xla_force_host_platform_device_count=(\d+)", flags)
if m and int(m.group(1)) < 8:
    # replace a smaller inherited count — the sharding tests need 8
    flags = flags.replace(
        m.group(0), "--xla_force_host_platform_device_count=8"
    )
    os.environ["XLA_FLAGS"] = flags
elif not m:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402,F401
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip: tests marked ``gpu`` run only on a card
    (``AM_TEST_PLATFORM=gpu``)."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: run with AM_TEST_PLATFORM=gpu on a card "
            f"(this run's platform is {dev.platform!r})"
        )
    return dev

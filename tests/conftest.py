"""Test harness: an 8-device virtual CPU mesh by default.

The suite runs on the host CPU with 8 virtual devices, so the multi-device
sharding paths are exercised without hardware (the reference has no
distributed tests at all; see SURVEY.md §4).  Tests marked ``chip`` need an
NVIDIA GPU and skip elsewhere; run them on a GPU machine with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m chip``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bounded_jit_cache_per_module():
    """Drop compiled executables between test modules.

    The full suite compiles thousands of distinct XLA CPU programs in one
    process; letting them accumulate made the run progressively slower and
    eventually SEGFAULT inside libgcc unwinding (reproducibly at ~160
    tests in; either half of the suite alone is fine).  Per-module
    ``jax.clear_caches()`` bounds the live-executable count — the
    recompiles it causes are small next to the pathology it removes.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def cpu_devices():
    devs = jax.devices()
    assert len(devs) == 8, f"expected 8 virtual CPU devices, got {devs}"
    return devs


@pytest.fixture
def gpu():
    """The first device when it is a GPU; otherwise the test skips."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest tests -m chip)")
    return dev

import os

import pytest

# Tests run on the CPU (JAX_PLATFORMS=cpu unless the caller names
# another platform, as the GPU tests' command does) on a virtual
# 8-device mesh, so sharding logic is exercised without a multi-card
# host.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "e2e: CPU-scaled end-to-end bench secondaries (pileup, family, "
        "megabase) run as tests so kernel-key changes cannot land "
        "without driving the bench paths")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU (the CUDA kernels have no CPU mode); "
        "skips elsewhere. Run on the card with "
        "JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/")


@pytest.fixture
def emulated_kernels():
    """CPU fills take the Hopper kernels' wrappers (kernel loops run
    as NumPy transcriptions, tests/hopper_emulator.py)."""
    import hopper_emulator
    with hopper_emulator.kernels_on_cpu():
        yield


@pytest.fixture
def gpu():
    """Skip unless JAX's first device is an NVIDIA GPU."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")

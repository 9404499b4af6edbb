import os

# Tests run on the CPU with 8 virtual devices, so sharding tests work
# anywhere; Pallas kernels run in interpret mode there
# (webdgs.config.use_interpret_mode).  Where JAX_PLATFORMS is set, it
# is left alone: `JAX_PLATFORMS=cuda pytest -m gpu` runs the card's tests.
if not os.environ.get("JAX_PLATFORMS"):
    os.environ["JAX_PLATFORMS"] = "cpu"
if os.environ["JAX_PLATFORMS"] == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture()
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, so
    every test worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (run with: JAX_PLATFORMS=cuda pytest -m gpu)")
    return jax.devices()[0]

"""Test configuration.

By default every test runs on the host CPU with 8 virtual devices, so the
sharding tests exercise real multi-device paths
(XLA_FLAGS --xla_force_host_platform_device_count) and the CPU tests run
in float64.  Tests that need the GPU carry the ``gpu`` marker; they skip
on the CPU.  Run them on a GPU machine with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

(any JAX_PLATFORMS other than ``cpu`` leaves the session on the default
accelerator).
"""
import os

_ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"

if _ON_CPU:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax

if _ON_CPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

from indy7_mpc.utils.cache import enable_cache  # noqa: E402

enable_cache()  # persistent compile cache: repeat suite runs skip compiles

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """``gpu``-marked tests need a GPU default device; skip otherwise."""
    if request.node.get_closest_marker("gpu") is None:
        return
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU (default device: {d.platform})")


@pytest.fixture(scope="session")
def model64():
    from indy7_mpc.models import indy7

    return indy7(dtype=jnp.float64)


@pytest.fixture(scope="session")
def model32():
    from indy7_mpc.models import indy7

    return indy7(dtype=jnp.float32)


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native", "plant")


@pytest.fixture(scope="session")
def native_build():
    """Build the native C++ plant (shared lib + plant_node) once per
    session so the C++<->JAX parity and UDP e2e tests RUN instead of
    silently skipping on a fresh checkout (the binaries are untracked)."""
    import subprocess

    lib = os.path.join(_NATIVE_DIR, "libindy7plant.so")
    exe = os.path.join(_NATIVE_DIR, "plant_node")
    if not (os.path.exists(lib) and os.path.exists(exe)):
        r = subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-j4"],
            capture_output=True, text=True,
        )
        if r.returncode != 0:
            pytest.skip(f"native build failed: {r.stderr[-400:]}")
    return _NATIVE_DIR

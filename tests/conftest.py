"""Test configuration: run on a virtual 8-device CPU mesh with x64 enabled.

This is the "fake backend" the reference lacks (SURVEY.md §4):
multi-device semantics are exercised on CPU via
``--xla_force_host_platform_device_count``, and float64 lets tests compare
against the float64 oracle at tight tolerances.  Checks that need the GPU
carry the ``chip`` marker and skip here; ``python chip_smoke.py`` runs them
as its phases on the card.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# the env var may have been read before this conftest ran (e.g. another
# pytest plugin importing jax first) — force the config too
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cbet_raytracing_3d_tpu.config import Config  # noqa: E402
from cbet_raytracing_3d_tpu.profiles import load_profiles  # noqa: E402


@pytest.fixture(autouse=True)
def _skip_chip_tests(request):
    """``chip``-marked tests need the GPU; decided per test, at run time."""
    if (request.node.get_closest_marker("chip")
            and jax.default_backend() != "gpu"):
        pytest.skip("needs the GPU (run `python chip_smoke.py` on the card)")


@pytest.fixture(scope="session")
def profiles():
    return load_profiles()


@pytest.fixture(scope="session")
def full_cfg():
    return Config(dtype="float64")


@pytest.fixture()
def rng(request):
    # fresh, per-test deterministic stream (independent of test order)
    seed = abs(hash(request.node.name)) % (2**31)
    return np.random.default_rng(seed)

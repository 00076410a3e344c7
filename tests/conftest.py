"""Test configuration: force JAX onto a virtual 8-device CPU mesh so that
sharding/collective code paths compile and run without a GPU.

`jax.config.update('jax_platforms', ...)` pins the backend even when jax was
imported before this file ran; XLA_FLAGS must still be set before the first
backend initialisation.

Tests that only a GPU can run carry the `gpu` marker and skip here; on a
GPU host `python chip_smoke.py` runs the same checks.
"""

import os
import shutil
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["PLATYPUS_TPU_PLATFORM"] = "cpu"  # spawned workers honour this

import jax

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips without one; chip_smoke.py runs "
        "the same checks on the card)")


@pytest.fixture(autouse=True)
def _skip_without_gpu(request):
    """Decided per test, at run time: a `gpu` test runs only on a host with
    a GPU (nvidia-smi and a JAX GPU plugin present)."""
    if request.node.get_closest_marker("gpu") is None:
        return
    from platypus_tpu.utils.backend import gpu_plugin_installed

    if shutil.which("nvidia-smi") is None or not gpu_plugin_installed():
        pytest.skip("needs a GPU: no nvidia-smi or no JAX GPU plugin here")

"""The one place that decides which platform this process computes on.

`device_platform()` reads the platform once and answers "cpu" or "gpu";
every device-path choice in the engine (alignment kernel, fused inference,
device flank scores, the device worker and the inference service) asks it.

`cpu_pinned()` answers from the environment alone, without importing jax:
a CPU-pinned process takes the native kernels everywhere and never pays
the jax import or an XLA client.  A parent process that only spawns
workers must not open the card either (a JAX process reserves most of the
card's memory), so it asks `cpu_pinned()` and `gpu_plugin_installed()`,
never `device_platform()`.
"""

from __future__ import annotations

import functools
import os

PLATFORMS = ("cpu", "gpu")


def cpu_pinned() -> bool:
    """True when this process's backend is explicitly pinned to cpu via
    PLATYPUS_TPU_PLATFORM or JAX_PLATFORMS.  Answerable from the
    environment alone — never imports jax, never initialises a backend."""
    if os.environ.get("PLATYPUS_TPU_PLATFORM") == "cpu":
        return True
    return os.environ.get("JAX_PLATFORMS", "") == "cpu"


@functools.lru_cache(maxsize=1)
def gpu_plugin_installed() -> bool:
    """True when a JAX GPU plugin is installed (package metadata only: no
    jax import, no device is opened)."""
    from importlib import metadata

    for dist in metadata.distributions():
        name = (dist.metadata["Name"] or "").lower().replace("_", "-")
        if name.startswith(("jax-cuda", "jax-rocm")):
            return True
    return False


def resolve_platform(observed: str, pinned: bool, plugin: bool) -> str:
    """The decision itself, from what was observed: the JAX backend name,
    whether the process was pinned to the CPU, and whether a GPU plugin is
    installed.  A process that was not pinned to the CPU, has a GPU plugin
    and still landed on the CPU lost its GPU at start-up: that is an error,
    never a silent CPU run."""
    if pinned:
        return "cpu"
    if observed not in PLATFORMS:
        raise RuntimeError(
            f"unsupported JAX platform {observed!r}: this caller runs on "
            f"{' or '.join(PLATFORMS)}")
    if observed == "cpu" and plugin:
        raise RuntimeError(
            "a JAX GPU plugin is installed but JAX initialised only the CPU; "
            "fix the GPU set-up, or pin the run to the CPU with "
            "PLATYPUS_TPU_PLATFORM=cpu (or JAX_PLATFORMS=cpu)")
    return observed


@functools.lru_cache(maxsize=1)
def device_platform() -> str:
    """"cpu" or "gpu": the platform this process computes on, read once.
    A CPU-pinned process answers without importing jax."""
    if cpu_pinned():
        return "cpu"
    import jax

    return resolve_platform(jax.default_backend(), False,
                            gpu_plugin_installed())

"""The platform decision (utils/backend.py) and the choices that follow it:
alignment path, fused inference, flank path, device workers, mesh shape,
compile-cache placement and device-failure containment."""

import os
import subprocess
import sys

import pytest

from platypus_tpu.utils import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("observed,pinned,plugin,want", [
    ("gpu", False, True, "gpu"),
    ("gpu", False, False, "gpu"),
    ("cpu", False, False, "cpu"),
    ("cpu", True, True, "cpu"),
    ("gpu", True, True, "cpu"),
    ("METAL", True, False, "cpu"),
])
def test_resolve_platform(observed, pinned, plugin, want):
    assert backend.resolve_platform(observed, pinned, plugin) == want


def test_cpu_fallback_with_gpu_plugin_is_an_error():
    """A GPU plugin that JAX could not start must not turn into a silent
    CPU run."""
    with pytest.raises(RuntimeError, match="GPU plugin"):
        backend.resolve_platform("cpu", False, True)


@pytest.mark.parametrize("observed", ["interpreter", "rocm", "METAL"])
def test_unsupported_platform_is_an_error(observed):
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        backend.resolve_platform(observed, False, False)


@pytest.mark.parametrize("env,want", [
    ({"PLATYPUS_TPU_PLATFORM": "cpu"}, True),
    ({"JAX_PLATFORMS": "cpu"}, True),
    ({"JAX_PLATFORMS": "cuda"}, False),
    ({}, False),
])
def test_cpu_pinned_reads_the_environment(monkeypatch, env, want):
    monkeypatch.delenv("PLATYPUS_TPU_PLATFORM", raising=False)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert backend.cpu_pinned() is want


def test_device_platform_here_is_cpu():
    assert backend.device_platform() == "cpu"
    assert backend.gpu_plugin_installed() is False


def test_cpu_pinned_process_never_imports_jax():
    code = ("import sys; from platypus_tpu.utils.backend import "
            "device_platform; print(device_platform(), 'jax' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PLATYPUS_TPU_PLATFORM="cpu"),
                         capture_output=True, text=True, check=True)
    assert out.stdout.split() == ["cpu", "False"]


@pytest.mark.parametrize("platform,mode,want", [
    ("cpu", "1", True), ("gpu", "1", False), ("gpu", "force", True),
    ("cpu", "0", False),
])
def test_native_alignment_follows_platform(monkeypatch, platform, mode, want):
    """The CPU aligns with the native kernel, the GPU with the XLA scan."""
    from platypus_tpu.engine import score

    monkeypatch.setattr(backend, "device_platform", lambda: platform)
    monkeypatch.setenv("PLATYPUS_TPU_NATIVE_ALIGN", mode)
    assert score._use_native_cpu_align() is want


@pytest.mark.parametrize("platform,setting,want", [
    ("gpu", -1, True), ("cpu", -1, False), ("gpu", 0, False), ("cpu", 1, True),
])
def test_device_inference_follows_platform(monkeypatch, platform, setting, want):
    from platypus_tpu.config import PlatypusConfig
    from platypus_tpu.engine.region import _device_inference_enabled

    monkeypatch.setattr(backend, "device_platform", lambda: platform)
    assert _device_inference_enabled(
        PlatypusConfig(device_inference=setting)) is want


@pytest.mark.parametrize("platform,path", [
    ("gpu", "_device_flank_scores"), ("cpu", "_scalar_flank_scores"),
])
def test_flank_path_follows_platform(monkeypatch, platform, path):
    from platypus_tpu.engine import score

    monkeypatch.setattr(backend, "device_platform", lambda: platform)
    called = []
    for name in ("_device_flank_scores", "_scalar_flank_scores"):
        monkeypatch.setattr(score, name,
                            lambda *a, _n=name: called.append(_n) or 0)
    score.flank_scores(None, 3, 2)
    assert called == [path]


@pytest.mark.parametrize("mode,pinned,plugin,n_host,want", [
    (-1, False, True, 1, 1),    # auto: GPU plugin, spare cores
    (-1, True, True, 1, 0),     # auto: pinned to the CPU
    (-1, False, False, 1, 0),   # auto: no GPU plugin
    (-1, False, True, 10**6, 0),  # auto: no spare core
    (1, True, False, 1, 1),     # forced
    (0, False, True, 1, 0),     # off
])
def test_device_worker_count(monkeypatch, mode, pinned, plugin, n_host, want):
    from platypus_tpu.config import PlatypusConfig
    from platypus_tpu.engine.runner import _n_device_workers

    monkeypatch.delenv("PLATYPUS_TPU_HYBRID_WORKER", raising=False)
    monkeypatch.setattr(backend, "cpu_pinned", lambda: pinned)
    monkeypatch.setattr(backend, "gpu_plugin_installed", lambda: plugin)
    assert _n_device_workers(PlatypusConfig(tpu_workers=mode), n_host) == want


@pytest.mark.parametrize("n", [1, 2, 4, 6, 8])
def test_mesh_puts_devices_on_windows(n):
    from platypus_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n)
    assert (mesh.shape["win"], mesh.shape["lane"]) == (n, 1)


@pytest.mark.parametrize("n,lane,win", [(8, 2, 4), (4, 2, 2), (6, 3, 2),
                                        (8, 8, 1)])
def test_mesh_lane_axis_shards_reads(n, lane, win):
    from platypus_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n, lane=lane)
    assert (mesh.shape["win"], mesh.shape["lane"]) == (win, lane)


def test_mesh_lane_must_divide_devices():
    from platypus_tpu.parallel.mesh import make_mesh

    with pytest.raises(ValueError):
        make_mesh(6, lane=4)


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and the code sets no other directory;
    without it the cache goes to the fixed in-checkout directory."""
    code = ("import jax; from platypus_tpu.ops import align_jax; "
            "print(jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, check=True)
    want = str(tmp_path) if env_dir else os.path.join(REPO, ".jax_cache")
    assert out.stdout.strip() == want


def test_device_errors_are_not_contained():
    """Region crash containment skips a region that raises, but a failure
    of the device runtime ends the run."""
    import jax

    from platypus_tpu.engine.runner import _contain

    _contain(ValueError("bad data"), "chr20", 0, 100)  # logged, contained
    err = jax.errors.JaxRuntimeError("device lost")
    with pytest.raises(jax.errors.JaxRuntimeError):
        _contain(err, "chr20", 0, 100)

"""chip_smoke.py and the run-time paths it relies on, as far as a host
without a GPU can check them. The phases themselves run on the card
(``python chip_smoke.py``); ``test_chip_smoke_passes_on_gpu`` runs them
there (``python -m pytest tests/test_chip_smoke.py -m gpu``)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from source_tpu import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(cwd, env, timeout=300):
    return subprocess.run([sys.executable, os.path.join(cwd, "chip_smoke.py")],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_result_line_format():
    sys.path.insert(0, ROOT)
    import chip_smoke

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    line = json.loads(chip_smoke.result_line(True, [Dev()]))
    assert line == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert json.loads(chip_smoke.result_line(0, [Dev()] * 4))["device"]["count"] == 4


def test_exits_nonzero_without_gpu():
    out = _run(ROOT, dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["ok"] is False and "device" not in last


def test_exits_nonzero_outside_the_checkout(tmp_path):
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    out = _run(str(tmp_path), dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode != 0
    assert json.loads(out.stdout.strip().splitlines()[-1])["ok"] is False


@pytest.mark.parametrize("environ,expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/cache/from/env"}, "/cache/from/env"),
    ({}, os.path.join(ROOT, ".jax_cache")),
    ({"JAX_COMPILATION_CACHE_DIR": ""}, os.path.join(ROOT, ".jax_cache")),
])
def test_compile_cache_dir_resolution(environ, expected):
    assert runtime.compile_cache_dir(environ) == expected


@pytest.mark.parametrize("env_dir", [None, "/cache/from/env"])
def test_enable_compile_cache_sets_config_only_without_env(env_dir, monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    path = runtime.enable_compile_cache()
    if env_dir is None:
        assert calls == [("jax_compilation_cache_dir", path)]
        assert path == os.path.join(ROOT, ".jax_cache")
    else:
        assert calls == [] and path == env_dir


@pytest.mark.parametrize("name", ["bvh", "meshio"])
def test_native_library_built_inside_checkout_keyed_on_content(name):
    path = runtime.build_native(name)
    assert os.path.dirname(path) == runtime.NATIVE_BUILD_DIR
    assert path.startswith(ROOT + os.sep) and os.path.exists(path)
    assert runtime.build_native(name) == path  # reused, not rebuilt
    # other flags -> another key, so a stale library is never loaded
    assert runtime.build_native(name, flags=("-O1",)) != path
    assert runtime.build_native("no_such_source") is None


@pytest.fixture
def gpu_env():
    """The environment without the test session's CPU pin, once a child
    process has found a GPU in it (this process is pinned to the CPU)."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    probe = subprocess.run(
        [sys.executable, "-c", "import jax; assert jax.devices('gpu')"],
        env=env, capture_output=True, timeout=300)
    if probe.returncode != 0:
        pytest.skip("needs an NVIDIA GPU (run on the card: python chip_smoke.py)")
    return env


@pytest.mark.gpu
def test_chip_smoke_passes_on_gpu(gpu_env):
    out = _run(ROOT, gpu_env, timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["ok"] is True


def _tf32(x):
    """Round float32 values to TF32's 10-bit mantissa (nearest, ties away)."""
    import numpy as np

    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(1 << 12)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_colour_check_passes_f32_and_catches_tf32():
    """chip_smoke's colour check on a small CPU render: the RGB pipeline's
    XYZ frame matches the spectral frame's float64 contraction, and the
    same contraction on TF32-rounded operands fails the limit."""
    import numpy as np

    sys.path.insert(0, ROOT)
    import chip_smoke
    from source_tpu.optical.colour import resample_ciexyz
    from source_tpu.optical.observer import SpectralPowerPipeline2D

    spec = SpectralPowerPipeline2D(accumulate=False)
    cam, rgb = chip_smoke._cornell_camera(
        (16, 16), 2, extra_pipelines=[spec], ray_max_depth=4,
        max_wavefront_iters=4)
    cam.observe(seed=3)
    assert spec.frame.mean.max() > 0
    assert chip_smoke._colour_error(rgb, spec) <= chip_smoke.COLOUR_RTOL

    bins = spec.frame.mean.shape[-1]
    lo, hi = spec.min_wavelength, spec.max_wavelength
    cie = _tf32(resample_ciexyz(lo, hi, bins)).astype(np.float64)
    s = _tf32(spec.frame.mean).astype(np.float64)
    rgb.xyz_frame.mean[...] = (s @ cie * np.float32((hi - lo) / bins)).reshape(
        rgb.xyz_frame.mean.shape)
    assert chip_smoke._colour_error(rgb, spec) > 10 * chip_smoke.COLOUR_RTOL

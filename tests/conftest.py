"""Test config: run JAX on CPU with 8 virtual devices so multi-device
sharding tests work anywhere. Tests that need the GPU carry the ``gpu``
marker and skip here; chip_smoke.py runs the same checks on the card."""

import os

# Tests run on a virtual CPU mesh unless the caller names platforms
# (JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/ on the card).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (compiled kernels); skips "
        "without one")


@pytest.fixture
def gpu_device():
    """The first GPU, or skip: decided here, never at import."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: the compiled kernel runs only on the card")


@pytest.fixture(autouse=True, scope="module")
def _drop_jax_caches_between_modules():
    """Release jit executables + their constant buffers after each test
    module. A full suite run otherwise accumulates ~65k memory mappings
    (each live XLA:CPU buffer is its own mmap; jit caches pin every
    compiled function's constants) and crosses the kernel's default
    vm.max_map_count = 65530 — at which point mmap fails and XLA
    SIGSEGV/SIGABRTs inside the next large compile (reproduced: maps
    grew 52k -> 65.3k over the suite and the run died at 65.3k).
    Re-entry is cheap: executables reload from the persistent
    compilation cache."""
    yield
    import gc

    jax.clear_caches()
    gc.collect()


@pytest.fixture
def default_world():
    """The book's default world fixture (world.rs:20-41): one point light
    and two canonical spheres."""
    from raytracer_tpu import transforms
    from raytracer_tpu.scene import specs as S
    from raytracer_tpu.scene.builder import build_scene

    s1 = S.Sphere(
        material=S.Material(color=(0.8, 1.0, 0.6), diffuse=0.7, specular=0.2)
    )
    s2 = S.Sphere(transform=transforms.scaling(0.5, 0.5, 0.5))
    light = S.PointLight(position=(-10.0, 10.0, -10.0), intensity=(1.0, 1.0, 1.0))
    return build_scene([light, s1, s2])


def approx_eq(a, b, eps=1e-4):
    return np.all(np.abs(np.asarray(a) - np.asarray(b)) < eps)

"""raytracer_tpu — a differentiable Whitted ray tracer in JAX.

A from-scratch rebuild of the capabilities of the reference Rust renderer
(lerouxrgd/raytracer): YAML scene description in, PPM image out, with
spheres/planes/cubes/cylinders/cones/triangles, Phong shading, point and
area lights (soft shadows), reflection/refraction, procedural and image
texture patterns, OBJ meshes, groups and CSG.

Architecture (accelerator-first, not a port):
  * Scenes compile to SoA arrays (one padded table per primitive family).
  * Rendering is wavefront: whole ray batches flow through
    trace -> shade -> spawn-secondary passes unrolled to a fixed depth,
    the entire frame is one jit-compiled, differentiable program.
  * Ray->object-space transforms are batched einsums and intersection math
    is vectorized elementwise work; free meshes are searched by a Pallas
    kernel on the GPU (ops/mesh_kernel.py) and by a chunked scan elsewhere.
  * Multi-device scaling shards the pixel grid over a jax.sharding.Mesh with
    the scene replicated; gradients of scene parameters are averaged.
"""

import os as _os
from pathlib import Path as _Path

import jax as _jax

# Deep spawn-tree programs can take minutes to compile; persist compiled
# executables so every process after the first starts warm. JAX itself
# honours JAX_COMPILATION_CACHE_DIR (an empty value opts out); otherwise
# the cache lives in one fixed directory inside the checkout, so a copy
# of the checkout never reuses CPU executables built for another host.
if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    _jax.config.update(
        "jax_compilation_cache_dir",
        str(_Path(__file__).resolve().parent.parent / ".jax_cache"),
    )
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

# Keep large malloc buffers in the arena instead of mmap/munmap per
# allocation. numpy hands every >128 KB buffer straight back to the
# kernel on free, so each scene-compile array re-faults its pages on
# first touch, which is slow on VMs with slow page faults. Arena reuse
# avoids that at the cost of a sticky RSS high-water mark. Opt out:
# RAYTRACER_MALLOPT=0.
if _os.environ.get("RAYTRACER_MALLOPT", "1") != "0":
    try:
        import ctypes as _ctypes

        _libc = _ctypes.CDLL("libc.so.6", use_errno=True)
        _libc.mallopt(-3, 1 << 30)   # M_MMAP_THRESHOLD
        _libc.mallopt(-1, 1 << 30)   # M_TRIM_THRESHOLD
    except Exception:  # pragma: no cover - non-glibc platforms
        pass

from raytracer_tpu.constants import EPSILON
from raytracer_tpu import transforms
from raytracer_tpu.camera import Camera
from raytracer_tpu.canvas import Canvas

__version__ = "0.1.0"

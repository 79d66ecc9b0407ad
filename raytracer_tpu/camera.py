"""Camera: batched ray generation.

Semantics follow the reference camera (/root/reference/src/camera.rs:18-64):
half_width/half_height derived from fov and aspect, rays shot through pixel
centers on the z=-1 canvas through the inverse camera transform. Instead of
one ray per call, :func:`ray_grid` produces the entire pixel grid of rays as
arrays — the accelerator's unit of work is the whole frame (or a tile of it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from raytracer_tpu import transforms


@dataclass
class Camera:
    hsize: int
    vsize: int
    field_of_view: float
    transform: np.ndarray = field(default_factory=transforms.identity)

    def __post_init__(self):
        half_view = math.tan(self.field_of_view / 2.0)
        aspect = self.hsize / self.vsize
        if aspect >= 1.0:
            self.half_width = half_view
            self.half_height = half_view / aspect
        else:
            self.half_width = half_view * aspect
            self.half_height = half_view
        self.pixel_size = (self.half_width * 2.0) / self.hsize

    def with_transform(self, transform) -> "Camera":
        if isinstance(transform, transforms.Transform):
            transform = transform.matrix
        return Camera(self.hsize, self.vsize, self.field_of_view, np.asarray(transform, np.float32))


def ray_grid(camera: Camera, dtype=jnp.float32):
    """All primary rays for the camera, flattened in row-major (py, px) order.

    Returns ``(origins, directions)`` of shape ``[vsize*hsize, 3]``. Pixel
    (px, py) is at flat index ``py * hsize + px`` so the result reshapes to
    an image as ``[vsize, hsize, 3]``.
    """
    inv = np.linalg.inv(camera.transform).astype(np.float32)

    px = np.arange(camera.hsize, dtype=np.float32)
    py = np.arange(camera.vsize, dtype=np.float32)
    # Offsets from canvas edge to pixel centers (camera.rs:45-52).
    xoffset = (px + 0.5) * camera.pixel_size
    yoffset = (py + 0.5) * camera.pixel_size
    world_x = camera.half_width - xoffset      # +x is to the left
    world_y = camera.half_height - yoffset

    wx, wy = np.meshgrid(world_x, world_y)      # [vsize, hsize]
    n = camera.vsize * camera.hsize
    pixels_h = np.stack(
        [wx.ravel(), wy.ravel(), np.full(n, -1.0, np.float32), np.ones(n, np.float32)],
        axis=-1,
    )                                           # [n, 4] points on z=-1 canvas

    pixel_world = pixels_h @ inv.T              # [n, 4]
    origin_world = inv @ np.array([0.0, 0.0, 0.0, 1.0], np.float32)

    origins = np.broadcast_to(origin_world[:3], (n, 3))
    directions = pixel_world[:, :3] - origin_world[:3]
    directions = directions / np.linalg.norm(directions, axis=-1, keepdims=True)

    return jnp.asarray(origins, dtype), jnp.asarray(directions, dtype)


def view_transform_jax(from_p, to_p, up):
    """Differentiable view_transform (transformations.rs:122-134) in jnp:
    camera pose becomes a gradient target for inverse rendering."""
    from_p = jnp.asarray(from_p)
    to_p = jnp.asarray(to_p)
    up = jnp.asarray(up)
    norm = lambda v: v / jnp.maximum(jnp.linalg.norm(v), 1e-12)
    forward = norm(to_p - from_p)
    left = jnp.cross(forward, norm(up))
    true_up = jnp.cross(left, forward)
    orientation = jnp.stack([
        jnp.concatenate([left, jnp.zeros(1)]),
        jnp.concatenate([true_up, jnp.zeros(1)]),
        jnp.concatenate([-forward, jnp.zeros(1)]),
        jnp.asarray([0.0, 0.0, 0.0, 1.0]),
    ])
    trans = jnp.eye(4).at[:3, 3].set(-from_p)
    return orientation @ trans


def ray_grid_jax(cam_inv, hsize: int, vsize: int, field_of_view):
    """Differentiable whole-grid ray generation (camera.rs:45-64 math).

    ``cam_inv`` is the INVERSE camera matrix (e.g.
    ``jnp.linalg.inv(view_transform_jax(...))``); hsize/vsize are static.
    Returns (origins [n,3], directions [n,3]); grads flow to cam_inv and
    field_of_view.
    """
    half_view = jnp.tan(field_of_view / 2.0)
    aspect = hsize / vsize
    half_width = jnp.where(aspect >= 1.0, half_view, half_view * aspect)
    half_height = jnp.where(aspect >= 1.0, half_view / aspect, half_view)
    pixel_size = half_width * 2.0 / hsize

    px = jnp.arange(hsize) + 0.5
    py = jnp.arange(vsize) + 0.5
    world_x = half_width - px * pixel_size
    world_y = half_height - py * pixel_size
    wx, wy = jnp.meshgrid(world_x, world_y)
    n = hsize * vsize
    pixels_h = jnp.stack(
        [wx.ravel(), wy.ravel(), jnp.full(n, -1.0), jnp.ones(n)], axis=-1)
    # float32 products at full precision (the GPU may otherwise use TF32)
    pixel_world = jnp.matmul(pixels_h, cam_inv.T, precision="highest")
    origin_world = jnp.matmul(cam_inv, jnp.asarray([0.0, 0.0, 0.0, 1.0]),
                              precision="highest")
    directions = pixel_world[:, :3] - origin_world[:3]
    directions = directions / jnp.maximum(
        jnp.linalg.norm(directions, axis=-1, keepdims=True), 1e-12)
    origins = jnp.broadcast_to(origin_world[:3], (n, 3))
    return origins, directions


def ray_for_pixel(camera: Camera, px: int, py: int):
    """Single-ray reference helper (mirrors camera.rs:45-64) for tests."""
    origins, directions = ray_grid(camera)
    idx = py * camera.hsize + px
    return np.asarray(origins[idx]), np.asarray(directions[idx])

"""Mesh construction and sharded rendering.

Sharding layout (scaling-book style, pure DP over rays):

  * rays: ``NamedSharding(mesh, P("rays"))`` on axis 0 — each device owns a
    contiguous slab of the pixel grid;
  * scene: fully replicated (``P()``) — scene tables are small relative to
    device memory; meshes up to millions of triangles still fit replicated, and
    replication makes the forward pass collective-free.

The render itself is the same program as on one device
(:func:`raytracer_tpu.core.render.color_at`), run per device under
``shard_map`` on that device's slab of rays.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from raytracer_tpu.core import types as T
from raytracer_tpu.core.render import color_at

RAY_AXIS = "rays"
HOST_AXIS = "hosts"


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None, local_device_ids=None):
    """Initialize the multi-host JAX runtime (SURVEY §7.8: host x device).

    Call once per process before any device work. With no arguments the
    coordinator env vars (JAX_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS)
    are auto-detected; on a single process with no coordinator env this is
    a safe no-op. Returns (process_index, process_count).
    """
    already = getattr(jax._src.distributed.global_state, "client", None)
    if already is None:
        import os

        has_env = any(
            os.environ.get(k)
            for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")
        )
        if coordinator_address is not None or has_env:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes,
                process_id=process_id,
                local_device_ids=local_device_ids,
            )
    return jax.process_index(), jax.process_count()


def make_mesh(devices=None, axis: str = RAY_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def make_host_mesh(axis_host: str = HOST_AXIS, axis_dev: str = RAY_AXIS) -> Mesh:
    """2-D (hosts, devices-per-host) mesh over ALL global devices.

    Rays shard over both axes (pure DP needs no cross-host collectives in
    the forward pass); training grads are averaged over both axes.
    jax.devices() orders devices process-major, so rows of the mesh are
    hosts.
    """
    devs = np.asarray(jax.devices())
    n_proc = jax.process_count()
    return Mesh(devs.reshape(n_proc, -1), (axis_host, axis_dev))


def replicate_scene(scene: T.Scene, mesh: Mesh) -> T.Scene:
    """Place every scene array on the mesh fully replicated."""
    rep = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, rep), scene)


def shard_rays(origins, directions, mesh: Mesh, axis: str = RAY_AXIS):
    """Pad the ray batch to a multiple of the mesh size and shard axis 0."""
    n_dev = mesh.devices.size
    n = origins.shape[0]
    pad = -n % n_dev
    if pad:
        origins = jnp.pad(origins, ((0, pad), (0, 0)))
        # pad directions with a unit vector so normalize/intersect stay finite
        directions = jnp.concatenate(
            [directions, jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (pad, 3))]
        )
    sh = NamedSharding(mesh, P(axis))
    return jax.device_put(origins, sh), jax.device_put(directions, sh), n


def render_sharded(scene: T.Scene, camera, mesh: Mesh | None = None, *,
                   key=None, tile_rays=None, multihost=None):
    """Full-frame render with the ray axis sharded over ``mesh``.

    Tiles like the single-device renderer (the depth-4 spawn tree of a
    whole frame does not fit device memory), with each tile's rays split
    across every mesh axis (works for the 1-D device mesh and the 2-D
    :func:`make_host_mesh` host x device mesh alike); tiles keep the
    screen-block ordering so every device gets spatially coherent
    pixel squares. Returns a float32 numpy image.

    ``multihost`` (auto-detected): on a multi-process runtime each host
    materializes only its addressable shard of every tile
    (jax.make_array_from_callback — the pixel-id tiles are computed
    identically on every host, so no cross-host transfer happens), and
    the final image is assembled with a process allgather.

    Rays are generated ON DEVICE from the inverse camera matrix and
    sharded pixel-id tiles (core.render.tile_rays) — the host ships
    4 bytes per ray instead of 24, and each device derives exactly its
    own shard's rays.
    """
    from raytracer_tpu.core.render import _block_order, camera_consts, tile_rays as _tile_rays

    if mesh is None:
        mesh = make_mesh()
    if key is None:
        key = jax.random.PRNGKey(0)
    if multihost is None:
        multihost = jax.process_count() > 1
    n_dev = mesh.devices.size
    if tile_rays is None:
        n_free_tris = scene.static.counts[5] - scene.static.n_csg_tris
        per_dev = 1 << 12 if n_free_tris > 20000 else 1 << 16
        tile_rays = per_dev * n_dev

    n = camera.vsize * camera.hsize
    tile = min(tile_rays, n)
    order = _block_order(camera.vsize, camera.hsize)
    n_pad = -n % tile
    padded = (np.pad(order, (0, n_pad)) if n_pad else order).astype(np.int32)

    scene = replicate_scene(scene, mesh)
    ray_sh = NamedSharding(mesh, P(mesh.axis_names))
    rep_sh = NamedSharding(mesh, P())
    inv, consts = camera_consts(camera)
    inv = jax.device_put(inv, rep_sh)
    consts = jax.device_put(consts, rep_sh)
    limit = scene.static.recursion_limit
    hsize = camera.hsize

    def to_device(x):
        if multihost:
            return jax.make_array_from_callback(
                x.shape, ray_sh, lambda idx: x[idx]
            )
        return jax.device_put(jnp.asarray(x), ray_sh)

    # The mesh kernel is a Pallas call, which GSPMD cannot partition:
    # shard_map runs the whole tile program per device on its own rays
    # (check_vma=False: Pallas results carry no varying-axis types).
    def local(scene, inv, consts, idx, key):
        o, d = _tile_rays(inv, consts, idx, hsize)
        return color_at(scene, o, d, key, limit)

    run = jax.jit(jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(mesh.axis_names), P()),
        out_specs=P(mesh.axis_names), check_vma=False,
    ))

    parts = []
    for i in range(0, n + n_pad, tile):
        tkey = jax.random.fold_in(key, i)
        parts.append(run(scene, inv, consts,
                         to_device(padded[i : i + tile]), tkey))
    if multihost:
        from jax.experimental import multihost_utils

        gathered = [
            np.asarray(multihost_utils.process_allgather(p, tiled=True))
            for p in parts
        ]
        img = np.concatenate(gathered, 0)[:n].astype(np.float32)
    else:
        img = np.asarray(jnp.concatenate(parts, 0)[:n], np.float32)
    out = np.empty_like(img)
    out[order] = img
    return out.reshape(camera.vsize, camera.hsize, 3)

"""Pallas kernel (Triton route): nearest triangle hit per block of rays.

One program handles ``BR`` rays, which the renderer lays out as one
``BLOCK_SIDE`` x ``BLOCK_SIDE`` pixel square (render._block_order), so a
block's rays form a tight frustum. The program walks the mesh in chunks of
``CHUNK`` triangles inside a loop of its own: it slab-tests the chunk's AABB
(built at scene build time) against its rays and their running best t, and
runs Moller-Trumbore over the chunk in ``[BR, BT]`` tiles only when some ray
can still hit it. Loop and cull stay on the device: there is no launch per
chunk and no read of a predicate by the host.

Moller-Trumbore follows triangle.rs:93-115 with the per-triangle det
threshold (types.Scene.tri_det_eps) and t > 0 strictly, in the operation
order of intersect._mt, so the two paths agree to rounding.

The kernel returns the nearest hit's t and triangle index and carries no
gradient; intersect recomputes t, u and v of the winning triangle in jnp,
which is where gradients flow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytracer_tpu.constants import EPSILON

BLOCK_SIDE = 8                 # pixels per side of one program's square
BR = BLOCK_SIDE * BLOCK_SIDE   # rays per program
CHUNK = 256                    # triangles per culling AABB
BT = 32                        # triangles per Moller-Trumbore tile
N_PLANES = 10                  # p1.xyz, e1.xyz, e2.xyz, det_eps
NUM_WARPS = 4
NUM_STAGES = 1


def _kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, cap_ref,
            tri_ref, bb_ref, t_ref, i_ref, *, n_chunks, any_hit):
    ox, oy, oz = ox_ref[...], oy_ref[...], oz_ref[...]
    dx, dy, dz = dx_ref[...], dy_ref[...], dz_ref[...]
    cap = cap_ref[...]

    def inv(x):
        return 1.0 / jnp.where(jnp.abs(x) < 1e-12, 1e-12, x)

    ix, iy, iz = inv(dx), inv(dy), inv(dz)
    dxc, dyc, dzc = dx[:, None], dy[:, None], dz[:, None]
    oxc, oyc, ozc = ox[:, None], oy[:, None], oz[:, None]

    def tile(c, k, carry):
        bt, bi = carry
        base = c * CHUNK + k * BT
        sl = pl.ds(base, BT)

        def plane(p):
            return tri_ref[p, sl][None, :]

        p1x, p1y, p1z = plane(0), plane(1), plane(2)
        e1x, e1y, e1z = plane(3), plane(4), plane(5)
        e2x, e2y, e2z = plane(6), plane(7), plane(8)
        det_eps = plane(9)
        # pvec = d x e2
        px = dyc * e2z - dzc * e2y
        py = dzc * e2x - dxc * e2z
        pz = dxc * e2y - dyc * e2x
        det = e1x * px + e1y * py + e1z * pz
        ok = jnp.abs(det) >= det_eps
        f = 1.0 / jnp.where(ok, det, 1.0)
        sx, sy, sz = oxc - p1x, oyc - p1y, ozc - p1z
        u = f * (sx * px + sy * py + sz * pz)
        ok = ok & (u >= 0.0) & (u <= 1.0)
        # qvec = s x e1
        qx = sy * e1z - sz * e1y
        qy = sz * e1x - sx * e1z
        qz = sx * e1y - sy * e1x
        v = f * (dxc * qx + dyc * qy + dzc * qz)
        ok = ok & (v >= 0.0) & (u + v <= 1.0)
        t = f * (e2x * qx + e2y * qy + e2z * qz)
        t = jnp.where(ok & (t > 0.0), t, jnp.inf)
        tmin = jnp.min(t, axis=1)
        better = tmin < bt
        if any_hit:
            return jnp.where(better, tmin, bt), bi
        j = jnp.argmin(t, axis=1).astype(jnp.int32)
        return jnp.where(better, tmin, bt), jnp.where(better, base + j, bi)

    def chunk(c, carry):
        bt = carry[0]

        def slab(k, o, i):
            t0 = (bb_ref[k, c] - o) * i
            t1 = (bb_ref[k + 3, c] - o) * i
            return jnp.minimum(t0, t1), jnp.maximum(t0, t1)

        x0, x1 = slab(0, ox, ix)
        y0, y1 = slab(1, oy, iy)
        z0, z1 = slab(2, oz, iz)
        tmin = jnp.maximum(jnp.maximum(x0, y0), z0)
        tmax = jnp.minimum(jnp.minimum(x1, y1), z1)
        live = (tmin <= tmax + EPSILON) & (tmax >= 0.0) & (tmin < bt)
        n_live = jnp.sum(live.astype(jnp.int32))
        return jax.lax.cond(
            n_live > 0,
            lambda cr: jax.lax.fori_loop(
                0, CHUNK // BT, functools.partial(tile, c), cr),
            lambda cr: cr,
            carry,
        )

    init = (cap, jnp.zeros(cap.shape, jnp.int32))
    if any_hit:
        # existence query: stop once every ray has a hit below its cap (a
        # ray whose cap is <= 0 can never get one and counts as done)
        def cond(state):
            c, bt, _ = state
            todo = jnp.sum(((bt >= cap) & (cap > 0.0)).astype(jnp.int32))
            return (c < n_chunks) & (todo > 0)

        def body(state):
            c, bt, bi = state
            bt, bi = chunk(c, (bt, bi))
            return c + 1, bt, bi

        _, bt, bi = jax.lax.while_loop(cond, body, (jnp.int32(0), *init))
    else:
        bt, bi = jax.lax.fori_loop(0, n_chunks, chunk, init)
    t_ref[...] = jnp.where(bt < cap, bt, jnp.inf)
    i_ref[...] = bi


def mesh_nearest(origins, directions, planes, bb, t_cap=None, *,
                 any_hit=False, interpret=False):
    """Nearest triangle hit per ray.

    origins/directions: [R, 3], any R (padded here to a multiple of BR).
    planes: [N_PLANES, N_pad] f32 (pack_planes), N_pad a multiple of CHUNK.
    bb: [6, N_pad // CHUNK] chunk AABBs (min xyz, max xyz).
    t_cap: optional [R] search cap: hits at t >= cap report +inf.
    any_hit: existence query — the reported hit is some hit below the cap,
        not necessarily the nearest, and the chunk loop ends once every
        ray of the block has one.
    Returns (t [R], tri_index [R] i32); misses have t = +inf.
    """
    n_pad = planes.shape[1]
    n_chunks = n_pad // CHUNK
    assert planes.shape[0] == N_PLANES and n_pad % CHUNK == 0, planes.shape
    assert bb.shape == (6, n_chunks), (bb.shape, n_chunks)
    r = origins.shape[0]
    if t_cap is None:
        t_cap = jnp.full((r,), jnp.inf, jnp.float32)
    pad = -r % BR
    o = jnp.pad(origins.astype(jnp.float32), ((0, pad), (0, 0)))
    d = jnp.pad(directions.astype(jnp.float32), ((0, pad), (0, 0)),
                constant_values=1.0)
    # padding rays get cap 0: they can never hit and never keep a loop alive
    cap = jnp.pad(t_cap.astype(jnp.float32), (0, pad))
    rp = r + pad

    ray = pl.BlockSpec((BR,), lambda i: (i,))
    whole = pl.no_block_spec
    t, idx = pl.pallas_call(
        functools.partial(_kernel, n_chunks=n_chunks, any_hit=any_hit),
        grid=(rp // BR,),
        in_specs=[ray] * 7 + [whole, whole],
        out_specs=[ray, ray],
        out_shape=[jax.ShapeDtypeStruct((rp,), jnp.float32),
                   jax.ShapeDtypeStruct((rp,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="mesh_nearest",
    )(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], cap,
      planes, bb)
    return t[:r], idx[:r]


def pack_planes(p1, e1, e2, det_eps):
    """Host-side SoA table and chunk AABBs for :func:`mesh_nearest`.

    p1/e1/e2: [N, 3] world-space triangles; det_eps: [N] thresholds.
    Returns (planes [N_PLANES, N_pad] f32, bb [6, N_pad // CHUNK] f32).
    Padding triangles are degenerate with threshold +inf (never hit), and
    the AABB of the last, partial chunk covers its real triangles only.
    """
    import numpy as np

    p1, e1, e2 = (np.asarray(x, np.float32) for x in (p1, e1, e2))
    n = p1.shape[0]
    pad = -n % CHUNK
    planes = np.zeros((N_PLANES, n + pad), np.float32)
    planes[0:3, :n], planes[3:6, :n], planes[6:9, :n] = p1.T, e1.T, e2.T
    planes[9] = np.inf
    planes[9, :n] = det_eps
    v = np.stack([p1, p1 + e1, p1 + e2], 1)                   # [N, 3, 3]
    lo = np.pad(v.min(1), ((0, pad), (0, 0)), constant_values=np.inf)
    hi = np.pad(v.max(1), ((0, pad), (0, 0)), constant_values=-np.inf)
    bb = np.concatenate([lo.reshape(-1, CHUNK, 3).min(1),
                         hi.reshape(-1, CHUNK, 3).max(1)], 1).T
    return planes, np.ascontiguousarray(bb)

"""Batched ray-primitive intersection.

The reference intersects one ray against one shape at a time through an
enum dispatch (shapes.rs:204-246). Here a whole ray batch meets each
primitive FAMILY at once:

* quadric-ish families (sphere/plane/cube/cylinder/cone) transform the ray
  batch into every primitive's object space with one batched einsum, then
  run the family's closed-form solve elementwise;
* triangles are pre-transformed to world space at compile time, so
  Moller-Trumbore runs directly on the world rays: CSG triangles as dense
  columns, free meshes through a chunk-culled search that keeps the
  nearest hit per ray (the Pallas kernel of ops/mesh_kernel.py on the
  GPU, a lax.scan elsewhere; no [R, Nt] materialization for big meshes).

The result is a per-ray candidate table ``(t, gid, u, v)`` with +inf for
misses, replacing the reference's BTreeMap-of-intersections
(intersections.rs:66-73) with sorts/reductions.

Oracle semantics carried over exactly: every local-intersect formula,
epsilon guard and open/closed interval below mirrors the corresponding
shapes/*.rs function cited inline.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.constants import EPSILON
from raytracer_tpu.core import types as T
from raytracer_tpu.core.csg import apply_csg
from raytracer_tpu.ops import mesh_kernel as MK

INF = jnp.inf

# Triangles per culling chunk, shared by the scan and the GPU kernel so
# one build-time AABB table (Scene.mesh_bb_chunk) serves both.
TRI_CHUNK = MK.CHUNK


def select_col(x, idx):
    """x[r, idx[r]] for small trailing dims — a one-hot select-sum
    (a masked reduce instead of a gather; whether that still pays on the
    GPU is an open measurement).
    """
    c = x.shape[-1]
    cols = jax.lax.broadcasted_iota(jnp.int32, x.shape, x.ndim - 1)
    mask = cols == idx[..., None]
    if x.dtype == jnp.bool_:
        return jnp.any(mask & x, axis=-1)
    return jnp.sum(jnp.where(mask, x, 0), axis=-1)


def table_gather(table, idx, limit: int = 32):
    """``table[idx]`` without a gather when the table is small: a masked
    broadcast-reduce over the table axis (exact — no matmul rounding).
    Medium float tables (G <= 1024) go through a one-hot matmul — also
    exact, because each output row has exactly one non-zero product
    (value * 1.0) and zero terms add exactly, and
    precision=HIGHEST keeps the f32 inputs unrounded. Falls back to a
    real gather only for big tables (meshes), where the one-hot operand
    would dwarf the gather cost.

    The matmul path requires FINITE table values (0 * inf = NaN) — true
    for every float table routed here (materials, transforms, pattern
    params); tables with sentinel infinities (cyl_min/max) are only read
    as whole-family slices, never through table_gather.

    table: [G, ...rest]; idx: any integer shape; returns [*idx, ...rest].
    """
    g = table.shape[0]
    if g > limit and g <= 1024:
        dt = table.dtype
        if jnp.issubdtype(dt, jnp.floating):
            ft = table
        elif dt == jnp.bool_ or jnp.issubdtype(dt, jnp.integer):
            # exact for |values| < 2^24 — true for every id/flag table
            # routed here (material/pattern row ids, shadow flags)
            ft = table.astype(jnp.float32)
        else:
            return table[idx]
        oh = (idx[..., None] == jnp.arange(g)).astype(jnp.float32)
        flat = ft.reshape(g, -1)
        out = jnp.einsum("...g,gk->...k", oh, flat, precision="highest")
        out = out.reshape(idx.shape + table.shape[1:])
        return out if ft is table else out.astype(dt)
    if g > limit:
        return table[idx]
    mask = idx[..., None] == jnp.arange(g)               # [*idx, G]
    t = table.reshape((1,) * idx.ndim + table.shape)      # [1.., G, rest]
    m = mask.reshape(mask.shape + (1,) * (len(table.shape) - 1))
    if table.dtype == jnp.bool_:
        return jnp.any(m & t, axis=idx.ndim)
    return jnp.sum(jnp.where(m, t, 0), axis=idx.ndim)


def transform_row(scene: T.Scene, gid):
    """Row of ``scene.inv_tf``/``scene.normal_mat`` for each gid.

    Non-triangle gids map to themselves; triangle gids map through
    ``tri_tf_id`` to their SOURCE row (types.Scene.inv_tf layout) — the
    tables hold one row per triangle source, not per triangle.
    """
    st = scene.static
    g_nt = sum(st.counts[:5])
    if st.counts[5] == 0:
        return gid
    tri = jnp.clip(gid - g_nt, 0, scene.tri_tf_id.shape[0] - 1)
    return jnp.where(gid >= g_nt, g_nt + scene.tri_tf_id[tri], gid)


def _local_rays(inv_tf, origins, directions):
    """Transform ray batch into each primitive's object space.

    inv_tf [N,4,4]; origins/directions [R,3] -> ([R,N,3], [R,N,3]).
    Points use the translation column, vectors don't (rays.rs:19-24).
    """
    rot = inv_tf[:, :3, :3]                      # [N,3,3]
    trans = inv_tf[:, :3, 3]                     # [N,3]
    o = jnp.einsum("nij,rj->rni", rot, origins, precision="highest") + trans[None]
    d = jnp.einsum("nij,rj->rni", rot, directions, precision="highest")
    return o, d


def _safe_sqrt(x, ok):
    """sqrt with NaN-free gradients: the masked-out branch never sees a
    negative operand, and the derivative is clamped near zero (tangent
    hits have mathematically infinite dt/dparam; clamping keeps training
    finite — standard differentiable-rendering practice)."""
    return jnp.sqrt(jnp.maximum(jnp.where(ok, x, 1.0), 1e-10))


def _sphere_ts(o, d):
    """sphere.rs:64-80; unit sphere at origin, 2 candidate ts."""
    a = jnp.sum(d * d, -1)
    b = 2.0 * jnp.sum(d * o, -1)
    c = jnp.sum(o * o, -1) - 1.0
    disc = b * b - 4.0 * a * c
    ok = disc >= 0.0
    sq = _safe_sqrt(disc, ok)
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    return jnp.stack([jnp.where(ok, t1, INF), jnp.where(ok, t2, INF)], -1)


def _plane_ts(o, d):
    """plane.rs:66-73; xz-plane, parallel guard at EPSILON."""
    ok = jnp.abs(d[..., 1]) >= EPSILON
    t = -o[..., 1] / jnp.where(ok, d[..., 1], 1.0)
    return jnp.where(ok, t, INF)[..., None]


def check_axis(origin, direction, lo, hi):
    """cube.rs:67-85 slab helper (shared with AABBs)."""
    tmin_num = lo - origin
    tmax_num = hi - origin
    ok = jnp.abs(direction) >= EPSILON
    safe_d = jnp.where(ok, direction, 1.0)
    # sign-based +-inf instead of num*INF: 0*inf = NaN both forward (on
    # face-coplanar rays) and in the backward pass.
    tmin = jnp.where(ok, tmin_num / safe_d, jnp.where(tmin_num >= 0.0, INF, -INF))
    tmax = jnp.where(ok, tmax_num / safe_d, jnp.where(tmax_num >= 0.0, INF, -INF))
    swap = tmin > tmax
    return jnp.where(swap, tmax, tmin), jnp.where(swap, tmin, tmax)


def _cube_ts(o, d):
    """cube.rs:87-114; both slab ts (entry+exit), miss when tmin > tmax."""
    xtmin, xtmax = check_axis(o[..., 0], d[..., 0], -1.0, 1.0)
    ytmin, ytmax = check_axis(o[..., 1], d[..., 1], -1.0, 1.0)
    ztmin, ztmax = check_axis(o[..., 2], d[..., 2], -1.0, 1.0)
    tmin = jnp.maximum(jnp.maximum(xtmin, ytmin), ztmin)
    tmax = jnp.minimum(jnp.minimum(xtmax, ytmax), ztmax)
    ok = tmin <= tmax
    return jnp.stack([jnp.where(ok, tmin, INF), jnp.where(ok, tmax, INF)], -1)


def _cyl_ts(o, d, mn, mx, closed):
    """cylinder.rs:95-156: body hits y-clipped to (min, max), plus caps.

    4 candidate slots: body t0, body t1, lower cap, upper cap. (The
    reference caps total intersections at 2, dropping a cap hit in the
    degenerate body+2-caps case; we keep all real hits.)
    """
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    a = dx * dx + dz * dz
    parallel = jnp.abs(a) < EPSILON
    b = 2.0 * (ox * dx + oz * dz)
    c = ox * ox + oz * oz - 1.0
    disc = b * b - 4.0 * a * c
    ok = (~parallel) & (disc >= 0.0)
    sq = _safe_sqrt(disc, ok)
    den = jnp.where(parallel, 1.0, 2.0 * a)
    t0 = (-b - sq) / den
    t1 = (-b + sq) / den
    y0 = oy + t0 * dy
    y1 = oy + t1 * dy
    body0 = jnp.where(ok & (mn < y0) & (y0 < mx), t0, INF)
    body1 = jnp.where(ok & (mn < y1) & (y1 < mx), t1, INF)

    cap_ok = closed & (jnp.abs(dy) >= EPSILON)
    safe_dy = jnp.where(jnp.abs(dy) >= EPSILON, dy, 1.0)
    tl = (mn - oy) / safe_dy
    tu = (mx - oy) / safe_dy

    def in_radius(t):
        x = ox + t * dx
        z = oz + t * dz
        # tolerance: rays through the exact cap edge land on either side
        # of 1.0 depending on FMA contraction (the reference's exact <=
        # only passes its own oracle by f32 rounding luck, cylinder.rs:150)
        return x * x + z * z <= 1.0 + 1e-5

    capl = jnp.where(cap_ok & in_radius(tl), tl, INF)
    capu = jnp.where(cap_ok & in_radius(tu), tu, INF)
    return jnp.stack([body0, body1, capl, capu], -1)


def _cone_ts(o, d, mn, mx, closed):
    """cone.rs:123-165: double-napped cone, linear degenerate case, caps
    with radius |y|."""
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
    a = dx * dx - dy * dy + dz * dz
    b = 2.0 * (ox * dx - oy * dy + oz * dz)
    c = ox * ox - oy * oy + oz * oz

    a_small = jnp.abs(a) < EPSILON
    b_small = jnp.abs(b) < EPSILON
    # linear branch: single t = -c / (2b) in slot0
    t_lin = -c / jnp.where(b_small, 1.0, 2.0 * b)

    disc = b * b - 4.0 * a * c
    quad_ok = (~a_small) & (disc >= 0.0)
    sq = _safe_sqrt(disc, quad_ok)
    den = jnp.where(a_small, 1.0, 2.0 * a)
    tq0 = (-b - sq) / den
    tq1 = (-b + sq) / den
    swap = tq0 > tq1  # a may be negative (cone.rs:150-153)
    t0 = jnp.where(swap, tq1, tq0)
    t1 = jnp.where(swap, tq0, tq1)
    y0 = oy + t0 * dy
    y1 = oy + t1 * dy
    body0 = jnp.where(quad_ok & (mn < y0) & (y0 < mx), t0, INF)
    body1 = jnp.where(quad_ok & (mn < y1) & (y1 < mx), t1, INF)
    # linear case: y-range is NOT checked (cone.rs:133-140)
    body0 = jnp.where(a_small & ~b_small, t_lin, body0)
    body1 = jnp.where(a_small & ~b_small, INF, body1)

    cap_ok = closed & (jnp.abs(dy) >= EPSILON)
    safe_dy = jnp.where(jnp.abs(dy) >= EPSILON, dy, 1.0)
    tl = (mn - oy) / safe_dy
    tu = (mx - oy) / safe_dy

    def in_radius(t, y):
        x = ox + t * dx
        z = oz + t * dz
        return x * x + z * z <= jnp.abs(y) + 1e-5

    capl = jnp.where(cap_ok & in_radius(tl, mn), tl, INF)
    capu = jnp.where(cap_ok & in_radius(tu, mx), tu, INF)
    return jnp.stack([body0, body1, capl, capu], -1)


def _mt(o, d, p1, e1, e2, thresh):
    """triangle.rs:93-115 on broadcastable [..., 3] operands.

    Returns (t, u, v, ok) unmasked; ``ok`` is the reference's hit test
    (|det| >= thresh and the barycentric bounds). Shared by the candidate
    tables, the scan and the hit recomputation behind the mesh kernel, so
    every path evaluates the same expressions in the same order.
    """
    dce2 = jnp.cross(d, e2)
    det = jnp.sum(e1 * dce2, -1)
    ok = jnp.abs(det) >= thresh
    f = 1.0 / jnp.where(ok, det, 1.0)
    p1o = o - p1
    u = f * jnp.sum(p1o * dce2, -1)
    ok &= (u >= 0.0) & (u <= 1.0)
    oce1 = jnp.cross(p1o, e1)
    v = f * jnp.sum(d * oce1, -1)
    ok &= (v >= 0.0) & (u + v <= 1.0)
    t = f * jnp.sum(e2 * oce1, -1)
    return t, u, v, ok


def _tri_moller_trumbore(o, d, p1, e1, e2, det_eps=None):
    """triangle.rs:93-115 (world space; t identical, see types.py).

    o,d [R,3]; p1,e1,e2 [Tc,3] -> (t, u, v) each [R,Tc]; misses = +inf t.

    ``det_eps`` [Tc]: per-triangle det threshold (types.Scene
    .tri_det_eps) — the reference's |det| < EPSILON runs in OBJECT space
    and det scales by the instance transform's determinant under the
    world-space pretransform, so scene triangles MUST pass their own
    threshold (a fixed EPSILON erases scaled-down mesh instances).
    None = plain EPSILON (unit-instance callers: tests, raw kernels).
    """
    thresh = EPSILON if det_eps is None else det_eps[None]
    t, u, v, ok = _mt(o[:, None], d[:, None], p1[None], e1[None], e2[None],
                      thresh)
    return jnp.where(ok, t, INF), u, v


def _free_chunks(scene: T.Scene):
    """The free (non-CSG) triangles as TRI_CHUNK-triangle chunks for the
    scan: (p1, e1, e2 [Ch, TRI_CHUNK, 3], det_eps [Ch, TRI_CHUNK],
    bb_min, bb_max [Ch, 3]). Padding triangles are degenerate with
    threshold +inf, so they never hit. The chunk AABBs are the build-time
    table (builder.finish), made at exactly this chunk size."""
    st = scene.static
    start, count = st.n_csg_tris, st.counts[5] - st.n_csg_tris
    n_pad = -count % TRI_CHUNK
    sl = slice(start, start + count)

    def pad(x):
        return jnp.pad(x[sl], ((0, n_pad), (0, 0))).reshape(-1, TRI_CHUNK, 3)

    deps = jnp.pad(scene.tri_det_eps[sl], (0, n_pad),
                   constant_values=INF).reshape(-1, TRI_CHUNK)
    bb = scene.mesh_bb_chunk
    n_chunks = (count + n_pad) // TRI_CHUNK
    assert bb.shape == (6, n_chunks), (bb.shape, n_chunks)
    return (pad(scene.tri_p1), pad(scene.tri_e1), pad(scene.tri_e2), deps,
            bb[:3].T, bb[3:].T)


def _mesh_kernel(scene: T.Scene, origins, directions, t_cap=None,
                 any_hit=False):
    """(t, free-triangle index) from the GPU mesh kernel, outside autodiff:
    the kernel only searches, callers recompute what they differentiate."""
    sg = jax.lax.stop_gradient
    return MK.mesh_nearest(
        sg(origins), sg(directions), sg(scene.mesh_planes),
        sg(scene.mesh_bb_chunk), None if t_cap is None else sg(t_cap),
        any_hit=any_hit,
    )


def _by_platform(gpu, default):
    """``gpu()`` where the computation is lowered for CUDA, ``default()``
    elsewhere. Decided at lowering, not at trace time, so one process can
    render on the GPU and on the CPU alike."""
    return jax.lax.platform_dependent(cuda=gpu, default=default)


def _tri_behind(scene: T.Scene, origins, directions):
    """The free-triangle entry with the LARGEST t <= 0 (nearest behind
    the ray origin); feeds the n1/n2 container walk for transparent
    meshes (see candidate_hits). Returns (t [R] (-inf = none), gid [R]).

    On the GPU this is the kernel's nearest hit of the REVERSED ray:
    negating d negates the Moller-Trumbore determinant and leaves u, v
    and the numerators unchanged, so t reverses sign exactly — the
    nearest t' > 0 of (o, -d) is -t for the largest t < 0 of (o, d).
    Boundary delta vs the scan: an intersection at exactly t == 0 (a
    triangle through the ray origin itself, which is already
    EPSILON-offset off every surface) is excluded there and included by
    the scan.
    """
    def kernel():
        t, idx = _mesh_kernel(scene, origins, -directions)
        return jnp.where(jnp.isfinite(t), -t, -INF), _free_gid(scene, idx)

    return _by_platform(
        kernel, lambda: _tri_behind_scan(scene, origins, directions))


def _free_gid(scene: T.Scene, idx):
    st = scene.static
    count = st.counts[5] - st.n_csg_tris
    return sum(st.counts[:5]) + st.n_csg_tris + jnp.minimum(idx, count - 1)


def _tri_behind_scan(scene: T.Scene, origins, directions):
    """The free-triangle entry with the LARGEST t <= 0 (nearest behind the
    ray origin), chunked scan with line-AABB culling.

    A chunk can only contribute when the infinite line enters its AABB at
    some t <= 0, which forward-facing chunks (tmin > 0) fail — for camera
    rays nearly every chunk is culled, so this pass is cheap.

    Returns (t [R] (-inf = none), gid [R]); u/v are irrelevant (a t<=0
    entry can never be the hit, it only feeds the n1/n2 container walk).
    """
    r = origins.shape[0]
    p1, e1, e2, deps, bb_min, bb_max = _free_chunks(scene)
    n_chunks = p1.shape[0]

    inv_d = 1.0 / jnp.where(jnp.abs(directions) < 1e-12, 1e-12, directions)
    init = (jnp.full((r,), -INF), jnp.zeros((r,), jnp.int32))

    def body(carry, chunk):
        cp1, ce1, ce2, cde, cbase, cmin, cmax = chunk
        t0 = (cmin[None] - origins) * inv_d
        t1 = (cmax[None] - origins) * inv_d
        tmin = jnp.max(jnp.minimum(t0, t1), -1)
        tmax = jnp.min(jnp.maximum(t0, t1), -1)
        bt = carry[0]
        # relevant iff the line crosses the AABB at some t in (bt, 0]
        hit_bb = (tmin <= tmax + EPSILON) & (tmin <= 0.0) & (tmax > bt)

        def run(c):
            bt, bg = c
            ts, _, _ = _tri_moller_trumbore(
                origins, directions, cp1, ce1, ce2, det_eps=cde)
            ts = jnp.where((ts <= 0.0) & jnp.isfinite(ts), ts, -INF)
            j = jnp.argmax(ts, -1)
            ct = select_col(ts, j)
            better = ct > bt
            return (jnp.where(better, ct, bt), jnp.where(better, cbase + j, bg))

        return jax.lax.cond(jnp.any(hit_bb), run, lambda c: c, carry), None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * TRI_CHUNK
    (bt, bg), _ = jax.lax.scan(
        body, init, (p1, e1, e2, deps, bases, bb_min, bb_max))
    return bt, _free_gid(scene, bg)


def _static_hits(scene: T.Scene, origins, directions):
    """Candidate intersections for the statically-laid-out region: quadric
    families (fixed slots per primitive) then dense CSG triangles, with
    the CSG filter already applied. Returns (ts, gid, u, v) each [R, Cs]."""
    st = scene.static
    ns, npl, ncu, ncy, nco, nt = st.counts
    off = st.offsets
    r = origins.shape[0]

    ts_list, gid_cols = [], []

    def fam(name, n, fn, slots, extra=()):
        if n == 0:
            return
        o_l, d_l = _local_rays(
            scene.inv_tf[off[T.FAMILIES.index(name)] : off[T.FAMILIES.index(name)] + n],
            origins,
            directions,
        )
        ts = fn(o_l, d_l, *extra)                  # [R, n, slots]
        ts_list.append(ts.reshape(r, n * slots))
        base = off[T.FAMILIES.index(name)]
        gid_cols.append(np.repeat(np.arange(base, base + n, dtype=np.int32), slots))

    fam("sphere", ns, _sphere_ts, 2)
    fam("plane", npl, _plane_ts, 1)
    fam("cube", ncu, _cube_ts, 2)
    fam("cylinder", ncy, _cyl_ts, 4,
        extra=(scene.cyl_min[None], scene.cyl_max[None], scene.cyl_closed[None]))
    fam("cone", nco, _cone_ts, 4,
        extra=(scene.cone_min[None], scene.cone_max[None], scene.cone_closed[None]))

    n_static = sum(len(g) for g in gid_cols)
    static_gids = (
        np.concatenate(gid_cols) if gid_cols else np.zeros(0, np.int32)
    )

    # CSG triangles: dense columns (the filter needs every hit).
    nt_csg = _num_csg_tris(scene)
    tri_parts = []
    if nt_csg:
        tts, tu, tv = _tri_moller_trumbore(
            origins, directions,
            scene.tri_p1[:nt_csg], scene.tri_e1[:nt_csg], scene.tri_e2[:nt_csg],
            det_eps=scene.tri_det_eps[:nt_csg],
        )
        tri_off = sum(st.counts[:5])
        gids = np.arange(tri_off, tri_off + nt_csg, dtype=np.int32)
        static_gids = np.concatenate([static_gids, gids])
        tri_parts.append((tts, None, tu, tv))

    ts = jnp.concatenate(
        ts_list + [p[0] for p in tri_parts], axis=-1
    ) if (ts_list or tri_parts) else jnp.full((r, 1), INF)

    c_static = ts.shape[-1]
    gid = jnp.broadcast_to(
        jnp.asarray(
            np.pad(static_gids, (0, c_static - len(static_gids)))
            if len(static_gids) < c_static else static_gids
        )[None, :],
        (r, c_static),
    )

    u = jnp.full((r, c_static), 0.0)
    v = jnp.full((r, c_static), 0.0)
    if tri_parts:
        ntc = tri_parts[0][0].shape[-1]
        u = u.at[:, c_static - ntc :].set(tri_parts[0][2])
        v = v.at[:, c_static - ntc :].set(tri_parts[0][3])

    if st.csg_nodes:
        ts = apply_csg(scene, ts, static_gids, c_static)

    return ts, gid, u, v


def candidate_hits(scene: T.Scene, origins, directions):
    """All candidate intersections of a ray batch against the whole scene.

    Returns (ts [R,C], gid [R,C] i32, u [R,C], v [R,C]); misses have t=+inf.
    Column layout is static per scene: quadric families first (static gid
    per column), then CSG triangles (dense), then one column holding the
    nearest POSITIVE free-triangle hit, and — when a free mesh material is
    transparent — one column holding the nearest-BEHIND free-triangle
    entry (largest t <= 0, -inf when none). CSG filtering has already been
    applied to the static region.

    Why two columns are *exact* for the reference's n1/n2 container walk
    (intersections.rs:141-160), which consumes ALL intersections incl.
    negative t: each triangle is its own container object (triangle.rs
    shapes are independent), a ray meets a given triangle at most once, so
    every triangle entry strictly before the hit is an OPEN container —
    and the walk only ever reads ``containers.last()``, the live entry
    with the largest (t, order) key. Free-triangle entries with
    0 < t < t_hit cannot exist (the nearest positive IS the hit
    candidate), so the only triangle entry the walk can select is the one
    with the largest t <= 0 — exactly the behind column. All other
    negative-t triangle entries are dominated and never observable.
    """
    st = scene.static
    nt = st.counts[5]
    nt_csg = st.n_csg_tris
    ts, gid, u, v = _static_hits(scene, origins, directions)

    nt_free = nt - nt_csg
    if nt_free > 0:
        # Cap the mesh search at the nearest positive static hit: a
        # triangle at t >= that cap can never win first_hit (the static
        # column is closer) and is never consumed by the n1/n2 walk
        # (which only reads entries with t <= t_hit), so erasing it is
        # exact — and the cap seeds the mesh search's chunk gates.
        pos = (ts > 0.0) & jnp.isfinite(ts)
        t_cap = jnp.min(jnp.where(pos, ts, INF), axis=-1)
        ft, fg, fu, fv = _tri_free_nearest(
            scene, origins, directions, t_cap=t_cap
        )
        cols_t, cols_g, cols_u, cols_v = [ft], [fg], [fu], [fv]
        if st.mesh_transparent:
            bt, bg = _tri_behind(scene, origins, directions)
            cols_t.append(bt)
            cols_g.append(bg)
            cols_u.append(jnp.zeros_like(bt))
            cols_v.append(jnp.zeros_like(bt))
        ts = jnp.concatenate([ts] + [c[:, None] for c in cols_t], -1)
        gid = jnp.concatenate([gid] + [c[:, None] for c in cols_g], -1)
        u = jnp.concatenate([u] + [c[:, None] for c in cols_u], -1)
        v = jnp.concatenate([v] + [c[:, None] for c in cols_v], -1)

    return ts, gid, u, v


def _tri_free_nearest(scene: T.Scene, origins, directions, t_cap=None,
                      any_hit=False):
    """Nearest positive hit over the free (non-CSG) triangles.

    ``t_cap`` [R] (optional): per-ray search cap — hits at t >= cap
    report +inf. Callers pass the nearest positive static-primitive t,
    which is exact for every consumer (see candidate_hits) and lets the
    AABB gates reject statically-occluded geometry.

    ``any_hit``: existence-only query (shadow rays where every mesh
    source casts shadows): the GPU kernel reports some hit below the cap,
    not necessarily the nearest, and stops once every ray of its block
    found one; u/v are then zero. The scan ignores the flag (its exact t
    yields the same blocked verdict — see shadow_blocked).

    One path per platform: the Pallas kernel (ops/mesh_kernel.py) on the
    GPU, the scan everywhere else; the scan is the kernel's reference.
    """
    return _by_platform(
        lambda: _tri_free_nearest_gpu(
            scene, origins, directions, t_cap, any_hit),
        lambda: _tri_free_nearest_scan(scene, origins, directions, t_cap),
    )


def _tri_free_nearest_gpu(scene: T.Scene, origins, directions, t_cap=None,
                          any_hit=False):
    """The kernel's search, then t, u and v of the winning triangle
    recomputed in jnp: the value of t is the kernel's, its gradient (and
    u, v) come from the recomputation, which differentiates exactly like
    the scan's gather of its winning column."""
    t_k, idx = _mesh_kernel(scene, origins, directions, t_cap, any_hit)
    gid = _free_gid(scene, idx)
    if any_hit:
        z = jnp.zeros_like(t_k)
        return t_k, gid, z, z
    hit = jnp.isfinite(t_k)
    tri = gid - sum(scene.static.counts[:5])
    # misses get threshold +inf, so their recomputation stays finite and
    # their (masked) gradient is zero, not NaN
    t, u, v, _ = _mt(origins, directions, scene.tri_p1[tri],
                     scene.tri_e1[tri], scene.tri_e2[tri],
                     jnp.where(hit, 0.0, INF))
    t = jnp.where(hit, t_k + (t - jax.lax.stop_gradient(t)), INF)
    return t, gid, jnp.where(hit, u, 0.0), jnp.where(hit, v, 0.0)


def _tri_free_nearest_scan(scene: T.Scene, origins, directions, t_cap=None):
    """Nearest positive hit over the free triangles, chunked scan with
    per-chunk AABB culling — the plain reference of the GPU kernel.

    Chunks are spatially coherent (builder Morton-orders free triangles),
    so a whole chunk whose AABB no ray in the batch enters is skipped via
    lax.cond. ``t_cap`` [R] seeds the running best-t (see
    _tri_free_nearest).

    Returns (t [R], gid [R], u [R], v [R]); misses have t=+inf.
    """
    r = origins.shape[0]
    p1, e1, e2, deps, bb_min, bb_max = _free_chunks(scene)
    n_chunks = p1.shape[0]

    inv_d = 1.0 / jnp.where(jnp.abs(directions) < 1e-12, 1e-12, directions)

    init = (
        jnp.full((r,), INF) if t_cap is None else t_cap,
        jnp.zeros((r,), jnp.int32),
        jnp.zeros((r,)),
        jnp.zeros((r,)),
    )

    def body(carry, chunk):
        cp1, ce1, ce2, cde, cbase, cmin, cmax = chunk

        t0 = (cmin[None] - origins) * inv_d            # [R,3]
        t1 = (cmax[None] - origins) * inv_d
        tmin = jnp.max(jnp.minimum(t0, t1), -1)
        tmax = jnp.min(jnp.maximum(t0, t1), -1)
        bt = carry[0]
        # chunk relevant if some ray enters the AABB before its current hit
        hit_bb = (tmin <= tmax + EPSILON) & (tmax >= 0.0) & (tmin < bt)

        def run(c):
            bt, bg, bu, bv = c
            ts, u, v = _tri_moller_trumbore(
                origins, directions, cp1, ce1, ce2, det_eps=cde)
            ts = jnp.where(ts > 0.0, ts, INF)  # hit() takes t > 0 strictly
            j = jnp.argmin(ts, -1)
            take = lambda x: jnp.take_along_axis(x, j[:, None], -1)[:, 0]
            ct, cu, cv = take(ts), take(u), take(v)
            better = ct < bt
            return (
                jnp.where(better, ct, bt),
                jnp.where(better, cbase + j, bg),
                jnp.where(better, cu, bu),
                jnp.where(better, cv, bv),
            )

        carry = jax.lax.cond(jnp.any(hit_bb), run, lambda c: c, carry)
        return carry, None

    bases = jnp.arange(n_chunks, dtype=jnp.int32) * TRI_CHUNK
    (bt, bg, bu, bv), _ = jax.lax.scan(
        body, init, (p1, e1, e2, deps, bases, bb_min, bb_max)
    )
    if t_cap is not None:
        bt = jnp.where(bt < t_cap, bt, INF)
    return bt, _free_gid(scene, bg), bu, bv


def nearest_hit(scene: T.Scene, origins, directions):
    """The reference's hit() without materializing a candidate table:
    masked argmin over the static region merged with the chunk-culled
    nearest mesh hit. Exact when no transparent material needs the
    n1/n2 container walk (render picks this path from the static flags).

    Returns (has [R], t [R], gid [R], u [R], v [R]).
    """
    st = scene.static
    ts, gid, u, v = _static_hits(scene, origins, directions)
    pos = (ts > 0.0) & jnp.isfinite(ts)
    masked = jnp.where(pos, ts, INF)
    slot = jnp.argmin(masked, -1)
    take = lambda x: select_col(x, slot)
    t_s, g_s, u_s, v_s = take(masked), take(gid), take(u), take(v)

    nt_free = st.counts[5] - st.n_csg_tris
    if nt_free > 0:
        t_m, g_m, u_m, v_m = _tri_free_nearest(
            scene, origins, directions, t_cap=t_s
        )
        better = t_m < t_s
        t_s = jnp.where(better, t_m, t_s)
        g_s = jnp.where(better, g_m, g_s)
        u_s = jnp.where(better, u_m, u_s)
        v_s = jnp.where(better, v_m, v_s)

    has = jnp.isfinite(t_s)
    return has, t_s, g_s, u_s, v_s


def _shadow_static_ts(scene: T.Scene, over, direction):
    """Candidate ts of the quadric families for S shadow rays per
    receiver, with the receiver->object transform factored OUT of the
    sample axis: the origins einsum runs on [R, N] instead of [R*S, N]
    (S-fold less matmul work and memory traffic for area lights).

    over [R,3], direction [R,S,3] -> (ts [R,S,Cs], col_gid np.int32 [Cs]).
    """
    st = scene.static
    r, s = direction.shape[0], direction.shape[1]
    ts_list, gid_cols = [], []

    def fam(name, fn, slots, extra=()):
        fi = T.FAMILIES.index(name)
        off, n = st.offsets[fi], st.counts[fi]
        if n == 0:
            return
        inv = scene.inv_tf[off : off + n]
        rot = inv[:, :3, :3]
        trans = inv[:, :3, 3]
        o_l = (
            jnp.einsum("nij,rj->rni", rot, over, precision="highest")
            + trans[None]
        )                                                  # [R,N,3]
        d_l = jnp.einsum(
            "nij,rsj->rsni", rot, direction, precision="highest"
        )                                                  # [R,S,N,3]
        ts = fn(o_l[:, None], d_l, *extra)                 # [R,S,N,slots]
        ts_list.append(ts.reshape(r, s, n * slots))
        gid_cols.append(np.repeat(np.arange(off, off + n, dtype=np.int32), slots))

    fam("sphere", _sphere_ts, 2)
    fam("plane", _plane_ts, 1)
    fam("cube", _cube_ts, 2)
    fam("cylinder", _cyl_ts, 4,
        extra=(scene.cyl_min[None, None], scene.cyl_max[None, None],
               scene.cyl_closed[None, None]))
    fam("cone", _cone_ts, 4,
        extra=(scene.cone_min[None, None], scene.cone_max[None, None],
               scene.cone_closed[None, None]))

    if not ts_list:
        return jnp.full((r, s, 1), INF), np.zeros(1, np.int32)
    return (
        jnp.concatenate(ts_list, -1),
        np.concatenate(gid_cols),
    )


def shadow_blocked(scene: T.Scene, over, pos, live=None):
    """Blocked-from-light test, S light samples per receiver.

    world.rs:101-111 semantics per sample: the single nearest positive
    hit along the shadow ray decides via its shadow flag, and only when
    it lies closer than the light sample (a shadow:false object in
    front un-shadows).

    over [R,3], pos [R|1,S,3] -> bool [R,S]. Never materializes the
    gid/u/v candidate tables of the generic nearest_hit (shadow rays
    need only t and a per-column STATIC shadow flag), and factors the
    receiver transform out of the sample axis. ``live`` masks rows
    whose shadow result is discarded (missed/parked receivers): their
    ray direction is re-parked to +z so the mesh search's AABB gates
    reject them (a recomputed direction toward the light would
    otherwise point straight back into the scene).

    CSG scenes keep the factored layout too: the quadric columns (which
    include every CSG member) plus dense CSG-triangle columns run through
    ``apply_csg`` on the flattened [R*S, C] table — the filter only needs
    the t columns, never the gid/u/v tables the generic nearest_hit
    materializes, so a 10x10 area light over a CSG tree costs S shadow
    column-tables, not S full candidate tables.
    """
    st = scene.static
    v = pos - over[:, None]                                 # [R,S,3]
    dist = jnp.maximum(jnp.linalg.norm(v, axis=-1), 1e-12)  # [R,S]
    direction = v / dist[..., None]
    r, s = dist.shape[0], dist.shape[1]
    if live is not None:
        direction = jnp.where(
            live[:, None, None], direction,
            jnp.asarray([0.0, 0.0, 1.0], direction.dtype),
        )

    ts, col_gid = _shadow_static_ts(scene, over, direction)
    if st.csg_nodes:
        ntc = st.n_csg_tris
        if ntc:
            # CSG triangles need dense columns (the parity filter must
            # see every hit); world-space vertices, so no per-object
            # transform to factor — flatten the sample axis just here.
            flat_o = jnp.broadcast_to(over[:, None], (r, s, 3)).reshape(-1, 3)
            tts, _, _ = _tri_moller_trumbore(
                flat_o, direction.reshape(-1, 3),
                scene.tri_p1[:ntc], scene.tri_e1[:ntc], scene.tri_e2[:ntc],
                det_eps=scene.tri_det_eps[:ntc],
            )
            ts = jnp.concatenate([ts, tts.reshape(r, s, ntc)], -1)
            tri_off = sum(st.counts[:5])
            col_gid = np.concatenate([
                col_gid, np.arange(tri_off, tri_off + ntc, dtype=np.int32)
            ])
        c = ts.shape[-1]
        # the filter consumes RAW ts (negative hits toggle containment)
        ts = apply_csg(scene, ts.reshape(r * s, c), col_gid, c).reshape(
            r, s, c
        )

    pos_ok = (ts > 0.0) & jnp.isfinite(ts)
    masked = jnp.where(pos_ok, ts, INF)
    slot = jnp.argmin(masked, -1)
    t_s = select_col(masked, slot)                          # [R,S]
    # per-column shadow flags are static rows (triangle gids map through
    # their source row) — one tiny [C] gather, broadcast over samples
    flag_cols = table_gather(
        scene.shadow, transform_row(scene, jnp.asarray(col_gid))
    )
    flag_s = select_col(jnp.broadcast_to(flag_cols, masked.shape), slot)

    nt_free = st.counts[5] - st.n_csg_tris
    if nt_free > 0:
        flat_o = jnp.broadcast_to(over[:, None], (r, s, 3)).reshape(-1, 3)
        # Exact search cap: a mesh hit at or beyond the nearest static
        # hit can never be the deciding (nearest) intersection, and one
        # at or beyond the light sample distance decides "not blocked"
        # exactly as a miss does — so the segment [0, min(t_s, dist))
        # is the only region that matters, and the cap feeds the mesh
        # search's AABB gates. Dead rows (parked receivers, whose result
        # is discarded) get cap 0: no chunk is ever live for them and
        # they read as done to the any-hit early exit.
        t_cap = jnp.minimum(t_s, dist)
        if live is not None:
            t_cap = jnp.where(live[:, None], t_cap, 0.0)
        # When every triangle source casts shadows, only EXISTENCE of a
        # hit below the cap matters (any such hit flips the verdict to
        # blocked: it is nearer than the static decider and its flag is
        # True; t's exact value is never read past the comparisons
        # below, which any t in (0, cap) satisfies identically). The GPU
        # kernel then stops once every ray of a block found an occluder.
        t_m, g_m, _, _ = _tri_free_nearest(
            scene, flat_o, direction.reshape(-1, 3),
            t_cap=t_cap.reshape(-1), any_hit=bool(st.mesh_all_shadow),
        )
        t_m = t_m.reshape(r, s)
        better = t_m < t_s
        if st.mesh_all_shadow:
            # every triangle source casts shadows (static fact): skip the
            # per-hit flag lookup — it was a per-triangle-table gather
            flag_m = jnp.bool_(True)
        else:
            flag_m = table_gather(
                scene.shadow, transform_row(scene, g_m.reshape(r, s)))
        flag_s = jnp.where(better, flag_m, flag_s)
        t_s = jnp.minimum(t_m, t_s)

    return jnp.isfinite(t_s) & (t_s < dist) & flag_s


def candidate_meta(static: T.SceneStatic):
    """Static structure of the candidate column layout of
    :func:`candidate_hits`: per-column object id, and for every column the
    list of sibling columns belonging to the same object.

    Free-triangle columns (nearest-positive, and nearest-behind when the
    mesh is transparent) carry dynamic gids but each is its own object (a
    ray meets a given triangle once, and the two columns always hold
    different triangles: one has t > 0, the other t <= 0), so they have
    no siblings. Returns (obj_of_col int32 [C], siblings list[list[int]],
    c_static).
    """
    cols = []
    for name, slots in (("sphere", 2), ("plane", 1), ("cube", 2),
                        ("cylinder", 4), ("cone", 4)):
        off, n = static.family_range(name)
        for g in range(off, off + n):
            cols.extend([g] * slots)
    tri_off = sum(static.counts[:5])
    cols.extend(range(tri_off, tri_off + static.n_csg_tris))
    c_static = max(len(cols), 1)
    if not cols:
        cols = [0]

    nt_free = static.counts[5] - static.n_csg_tris
    # nearest-positive column, plus the nearest-behind column for
    # transparent meshes — must mirror candidate_hits' layout
    k = (1 + int(static.mesh_transparent)) if nt_free > 0 else 0
    # unique pseudo-object ids for the top-k columns
    next_obj = (max(cols) + 1) if cols else 0
    obj = np.asarray(cols + [next_obj + i for i in range(k)], np.int32)

    by_obj = {}
    for j, g in enumerate(cols):
        by_obj.setdefault(g, []).append(j)
    siblings = [
        [k2 for k2 in by_obj.get(int(obj[j]), []) if k2 != j]
        if j < len(cols) else []
        for j in range(len(obj))
    ]
    return obj, siblings, c_static


def _num_csg_tris(scene: T.Scene) -> int:
    """Number of leading triangles that belong to CSG trees (builder orders
    CSG triangles first; they need dense candidate columns)."""
    return scene.static.n_csg_tris


def sorted_hits(scene: T.Scene, origins, directions, k: int = 12):
    """The reference's sorted Intersections list, truncated to ``k``.

    TEST ORACLE ONLY — the production path never sorts (see first_hit);
    this mirrors intersections.rs:66-73 for the book-value tests.
    Returns (ts, gid, u, v) each [R, K], ascending by t, +inf padded.
    """
    ts, gid, u, v = candidate_hits(scene, origins, directions)
    # the behind column's "none" sentinel is -inf — treat as a miss here
    ts = jnp.where(jnp.isneginf(ts), INF, ts)
    k = min(k, ts.shape[-1])
    if ts.shape[-1] == k:
        order = jnp.argsort(ts, axis=-1)
        g = lambda x: jnp.take_along_axis(x, order, -1)
        return g(ts), g(gid), g(u), g(v)
    neg, sel = jax.lax.top_k(-ts, k)
    g = lambda x: jnp.take_along_axis(x, sel, -1)
    return -neg, g(gid), g(u), g(v)


def first_hit(ts, gid, u, v):
    """hit() = intersection with the smallest t > 0 (intersections.rs:94-96).

    Works on UNSORTED candidate tables (a masked argmin: the hot path
    never sorts the candidate axis).

    Returns (has_hit [R], t [R], gid [R], u [R], v [R], hit_slot [R]).
    """
    pos = (ts > 0.0) & jnp.isfinite(ts)
    masked = jnp.where(pos, ts, INF)
    slot = jnp.argmin(masked, -1)
    has = jnp.any(pos, -1)
    take = lambda x: select_col(x, slot)
    return has, take(ts), take(gid), take(u), take(v), slot

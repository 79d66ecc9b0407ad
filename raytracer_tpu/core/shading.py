"""Normals, Phong lighting, Fresnel and the refraction-index walk.

Mirrors materials.rs::lighting, intersections.rs::Computations::prepare /
schlick and world.rs shading semantics, vectorized over ray batches.
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracer_tpu.constants import EPSILON
from raytracer_tpu.core import types as T


def reflect(v, n):
    """tuples.rs:250-254: v - 2*dot(v,n)*n."""
    return v - 2.0 * jnp.sum(v * n, -1, keepdims=True) * n


def normalize(v, axis=-1):
    # clamped: degenerate vectors (e.g. the dummy normal of a missed ray)
    # must not poison gradients of everything else with 0/0.
    return v / jnp.maximum(jnp.linalg.norm(v, axis=axis, keepdims=True), 1e-12)


def normal_at(scene: T.Scene, gid, world_point, u, v, tgid=None, inv=None,
              nmat=None):
    """shapes.rs:187-202: world_to_object -> local_normal_at -> world.

    Family dispatch is by static gid ranges; every family's formula is
    evaluated and where-selected (no divergence). ``tgid``/``inv``/
    ``nmat``: precomputed compact rows and per-ray transform matrices,
    shared with the caller's material/pattern lookups (render.shade_level
    fetches them all in one one-hot matmul).
    """
    st = scene.static
    off = st.offsets
    ns, npl, ncu, ncy, nco, nt = st.counts

    from raytracer_tpu.core.intersect import table_gather, transform_row

    # compact transform tables: one row per SOURCE (types.Scene.inv_tf)
    if tgid is None:
        tgid = transform_row(scene, gid)
    if inv is None:
        inv = table_gather(scene.inv_tf, tgid)
    lp = jnp.einsum("rij,rj->ri", inv[:, :3, :3], world_point, precision="highest") + inv[:, :3, 3]
    lx, ly, lz = lp[:, 0], lp[:, 1], lp[:, 2]

    # sphere.rs:82-84: p - origin
    n_local = lp

    # plane.rs:75-77
    plane_n = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), lp.shape)

    # cube.rs:116-133: dominant axis, x-then-y-then-z tie-break
    maxc = jnp.maximum(jnp.maximum(jnp.abs(lx), jnp.abs(ly)), jnp.abs(lz))
    zeros = jnp.zeros_like(lx)
    cube_n = jnp.stack([zeros, zeros, lz], -1)
    cube_n = jnp.where((jnp.abs(ly) == maxc)[:, None],
                       jnp.stack([zeros, ly, zeros], -1), cube_n)
    cube_n = jnp.where((jnp.abs(lx) == maxc)[:, None],
                       jnp.stack([lx, zeros, zeros], -1), cube_n)

    # cylinder.rs:158-167 caps within EPSILON bands
    def capped_normal(local_idx, mins, maxs, side_n):
        mn = mins[local_idx]
        mx = maxs[local_idx]
        dist = lx * lx + lz * lz
        top = (dist < 1.0) & (ly >= mx - EPSILON)
        bot = (dist < 1.0) & (ly <= mn + EPSILON)
        n = side_n
        n = jnp.where(top[:, None], jnp.array([0.0, 1.0, 0.0]), n)
        n = jnp.where(bot[:, None], jnp.array([0.0, -1.0, 0.0]), n)
        return n

    if ncy:
        cyl_idx = jnp.clip(gid - off[3], 0, ncy - 1)
        cyl_side = jnp.stack([lx, zeros, lz], -1)
        cyl_n = capped_normal(cyl_idx, scene.cyl_min, scene.cyl_max, cyl_side)
    else:
        cyl_n = n_local
    if nco:
        cone_idx = jnp.clip(gid - off[4], 0, nco - 1)
        # cone.rs:167-180: y = -sign(ly)*sqrt(x^2+z^2)
        yy = jnp.sqrt(lx * lx + lz * lz)
        yy = jnp.where(ly > 0.0, -yy, yy)
        cone_side = jnp.stack([lx, yy, lz], -1)
        cone_n = capped_normal(cone_idx, scene.cone_min, scene.cone_max, cone_side)
    else:
        cone_n = n_local

    local = n_local
    for fam_i, n_fam in ((1, plane_n), (2, cube_n), (3, cyl_n), (4, cone_n)):
        lo = off[fam_i]
        hi = lo + st.counts[fam_i]
        in_fam = (gid >= lo) & (gid < hi)
        local = jnp.where(in_fam[:, None], n_fam, local)

    # non-triangle: local normal -> world via normal matrix + normalize
    if nmat is None:
        nmat = table_gather(scene.normal_mat, tgid)
    world_n = normalize(
        jnp.einsum("rij,rj->ri", nmat, local, precision="highest")
    )

    # triangles: stored world-space normals
    if nt:
        tri_lo = off[5]
        tidx = jnp.clip(gid - tri_lo, 0, nt - 1)
        row = scene.tri_shade[tidx]                        # [R, 13]
        interp = (
            u[:, None] * row[:, 3:6]
            + v[:, None] * row[:, 6:9]
            + (1.0 - u - v)[:, None] * row[:, 0:3]
        )
        tri_n = jnp.where(row[:, 12:13] != 0.0, normalize(interp), row[:, 9:12])
        world_n = jnp.where((gid >= tri_lo)[:, None], tri_n, world_n)

    return world_n


def phong(mat_rows, surface_color, light_intensity, light_pos, point, eyev, normalv):
    """One Phong sample (materials.rs:101-135 core): returns
    (diffuse+specular) [..., 3]; ambient handled by the caller.

    Fully elementwise over leading dims: area lights call this with
    [R, 1, ...] material/geometry rows against [R, S, 3] sample
    positions, so XLA fuses the broadcasts instead of materializing
    [R*S, 10] copies of the material table."""
    diffuse_f = mat_rows[..., T.MAT_DIFFUSE : T.MAT_DIFFUSE + 1]
    specular_f = mat_rows[..., T.MAT_SPECULAR : T.MAT_SPECULAR + 1]
    shininess = mat_rows[..., T.MAT_SHININESS]

    eff = surface_color * light_intensity
    lightv = normalize(light_pos - point)
    ldn = jnp.sum(lightv * normalv, -1)
    lit = ldn >= 0.0

    diffuse = eff * diffuse_f * ldn[..., None]

    reflectv = reflect(-lightv, normalv)
    rde = jnp.sum(reflectv * eyev, -1)
    spec_on = lit & (rde > 0.0)
    factor = jnp.power(jnp.maximum(rde, 0.0), shininess)
    specular = light_intensity * specular_f * factor[..., None]

    out = jnp.where(lit[..., None], diffuse, 0.0)
    out = out + jnp.where(spec_on[..., None], specular, 0.0)
    return out


def schlick(eyev, normalv, n1, n2):
    """intersections.rs:177-192 Fresnel approximation."""
    cos = jnp.sum(eyev * normalv, -1)
    n = n1 / n2
    sin2_t = n * n * (1.0 - cos * cos)
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 1e-10))
    cos_eff = jnp.where(n1 > n2, cos_t, cos)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    r = r0 + (1.0 - r0) * (1.0 - cos_eff) ** 5
    tir = (n1 > n2) & (sin2_t > 1.0)
    return jnp.where(tir, 1.0, r)


def refraction_indices_fast(scene: T.Scene, ts, gids, hit_slot):
    """n1/n2 container walk specialized to the canonical candidate layout
    of intersect.candidate_hits (UNSORTED, column->object map static).

    Same math as :func:`refraction_indices` but sibling columns of each
    object are known at compile time, so parity and latest-toggle checks
    unroll to a handful of [R, C] ops — no [R, C, C] tensors, far less
    memory traffic; the generic version remains as the oracle.
    """
    from raytracer_tpu.core.intersect import (
        candidate_meta, table_gather, transform_row,
    )

    obj_np, siblings, c_static = candidate_meta(scene.static)
    c = ts.shape[-1]
    assert len(obj_np) == c, (len(obj_np), c)
    idx = jnp.arange(c)
    valid = jnp.isfinite(ts)
    # Column -> refractive index. All static-region columns have
    # compile-time object ids, so their indices come from ONE [C_static]
    # lookup broadcast over rays; only the free-mesh columns (dynamic
    # per-triangle gid) need per-ray work — when every mesh source shares
    # one refractive index (static fact), even that is a constant.
    mat_refr = scene.mat[:, T.MAT_REFRACTIVE]              # [M] unique rows
    n_dyn = c - min(c_static, c)
    refr_static = jnp.broadcast_to(
        mat_refr[table_gather(
            scene.mat_id,
            transform_row(scene, jnp.asarray(obj_np[: c - n_dyn])),
        )][None, :],
        (ts.shape[0], c - n_dyn),
    )
    if n_dyn:
        uni = scene.static.mesh_uniform_refr
        if uni is not None:
            dyn_cols = [
                jnp.full((ts.shape[0], 1), jnp.float32(uni))
            ] * n_dyn
        else:
            dyn_cols = [
                table_gather(
                    mat_refr,
                    table_gather(scene.mat_id,
                                 transform_row(scene, gids[:, j])),
                )[:, None]
                for j in range(c - n_dyn, c)
            ]
        refr = jnp.concatenate([refr_static] + dyn_cols, -1)
    else:
        refr = refr_static

    from raytracer_tpu.core.intersect import select_col

    t_h = select_col(ts, hit_slot)[:, None]                # [R, 1]
    before = valid & (
        (ts < t_h) | ((ts == t_h) & (idx[None, :] < hit_slot[:, None]))
    )                                                      # [R, C]

    # per-column: parity of its object's toggles (one one-hot matmul
    # — exact small-integer counts), and later-same-object toggle
    # existence (one masked [R, C, C] pass) instead of ~C*4 tiny [R]
    # ops per level, which XLA would leave unfused.
    import numpy as np

    sib_m = np.zeros((c, c), bool)              # [k, j]: k sibling of j
    for j in range(c):
        for k in siblings[j]:
            sib_m[k, j] = True
    cnt = jnp.einsum(
        "rc,cd->rd", before.astype(jnp.float32),
        jnp.asarray(sib_m | np.eye(c, dtype=bool), jnp.float32),
        precision="highest",
    ).astype(jnp.int32)
    # restrict the pairwise pass to columns that have siblings at all
    # (bounds the [R, K, J] intermediate for column-heavy CSG scenes)
    ks = np.nonzero(sib_m.any(axis=1))[0]
    js = np.nonzero(sib_m.any(axis=0))[0]
    if len(ks):
        ts_k = ts[:, ks][:, :, None]
        ts_j = ts[:, js][:, None, :]
        later = (ts_k > ts_j) | (
            (ts_k == ts_j) & (ks[:, None] > js[None, :])[None]
        )                                       # [R, k, j]
        sup_js = jnp.any(
            jnp.asarray(sib_m[np.ix_(ks, js)])[None]
            & before[:, ks, None] & later, axis=1
        )                                       # [R, len(js)]
        superseded = jnp.zeros_like(before).at[:, js].set(sup_js)
    else:
        superseded = jnp.zeros_like(before)
    open_col = (cnt % 2) == 1
    live = before & ~superseded & open_col

    def latest(mask):
        big_t = jnp.where(mask, ts, -jnp.inf)
        m = jnp.max(big_t, -1, keepdims=True)
        at_max = mask & (big_t == m)
        j = jnp.max(jnp.where(at_max, idx[None, :], -1), -1)
        ri = select_col(refr, jnp.maximum(j, 0))
        return jnp.where(j >= 0, ri, 1.0)

    n1 = latest(live)

    obj_cols = jnp.asarray(obj_np)
    obj_h = select_col(
        jnp.broadcast_to(obj_cols[None, :], ts.shape), hit_slot
    )[:, None]                                              # [R, 1]
    h_was_open = select_col(open_col, hit_slot)
    refr_h = select_col(refr, hit_slot)
    n2_closed_h = latest(live & (obj_cols[None, :] != obj_h))
    n2 = jnp.where(h_was_open, n2_closed_h, refr_h)
    return n1, n2


def refraction_indices(scene: T.Scene, ts, gids, hit_slot):
    """n1/n2 via the container walk (intersections.rs:141-160), computed
    directly on the UNSORTED candidate table — no sort.

    Ordering comes from pairwise lexicographic keys (t, slot) instead of
    positions in a sorted list. Before the hit, object g is an *open
    container* iff it toggled an odd number of times; its entry time is
    its latest toggle. n1 = refractive index of the open container with
    the latest entry (reference's ``containers.last()``), n2 = the same
    after the hit toggles its own object: if the hit's object was open it
    closes (recompute excluding it), else the hit's object becomes the
    most recent container.
    """
    from raytracer_tpu.core.intersect import transform_row

    c = ts.shape[-1]
    idx = jnp.arange(c)
    valid = jnp.isfinite(ts)
    refr = scene.mat[
        scene.mat_id[transform_row(scene, gids)], T.MAT_REFRACTIVE
    ]                                                      # [R, C]

    t_h = jnp.take_along_axis(ts, hit_slot[:, None], -1)   # [R, 1]
    # strictly-before-hit by (t, slot) lexicographic order
    before = valid & (
        (ts < t_h) | ((ts == t_h) & (idx[None, :] < hit_slot[:, None]))
    )                                                      # [R, C]

    same = gids[:, :, None] == gids[:, None, :]            # [R, j, k]
    b_k = before[:, None, :]                               # [R, 1, k]
    # toggles of gid_j strictly before the hit
    cnt = jnp.sum(same & b_k, axis=-1)                     # [R, j]
    open_g = (cnt % 2) == 1

    # k is a later toggle of j's object (still before the hit)?
    key_gt = (ts[:, None, :] > ts[:, :, None]) | (
        (ts[:, None, :] == ts[:, :, None])
        & (idx[None, None, :] > idx[None, :, None])
    )
    superseded = jnp.any(same & b_k & key_gt, axis=-1)     # [R, j]
    live_push = before & ~superseded & open_g              # j = current entry of an open container

    def latest(mask):
        """Index of the masked candidate with the largest (t, slot) key."""
        big_t = jnp.where(mask, ts, -jnp.inf)
        m = jnp.max(big_t, -1, keepdims=True)
        at_max = mask & (big_t == m)
        j = jnp.max(jnp.where(at_max, idx[None, :], -1), -1)
        ri = jnp.take_along_axis(refr, jnp.maximum(j, 0)[:, None], -1)[:, 0]
        return jnp.where(j >= 0, ri, 1.0)

    n1 = latest(live_push)

    gid_h = jnp.take_along_axis(gids, hit_slot[:, None], -1)           # [R, 1]
    cnt_h = jnp.sum((gids == gid_h) & before, axis=-1)
    h_was_open = (cnt_h % 2) == 1
    refr_h = jnp.take_along_axis(refr, hit_slot[:, None], -1)[:, 0]
    n2_closed_h = latest(live_push & (gids != gid_h))
    n2 = jnp.where(h_was_open, n2_closed_h, refr_h)
    return n1, n2

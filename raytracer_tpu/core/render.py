"""The wavefront integrator: whole-frame ray batches, unrolled bounce tree.

The reference's recursive per-pixel color_at (world.rs:91-148) becomes a
level-by-level loop: level L holds every ray spawned at bounce depth L
(reflection and refraction children concatenated), each level is one batched
trace + shade, and contributions are pre-weighted by the product of
reflective/transparency/Schlick factors along the path — linearity makes
this exactly the recursive sum. Static scene flags prune branches whose
weight is identically zero (a scene with no transparent material never
spawns refraction rays, so the common case costs depth+1 traces, not 2^d).

Reference semantics preserved deliberately:
  * shade_hit adds reflected+refracted PER LIGHT (world.rs:64-89), so child
    weights are multiplied by the light count;
  * is_shadowed tests only the nearest positive hit's shadow flag
    (world.rs:101-111);
  * area lights draw fresh jitter for the intensity pass and the lighting
    pass (lights.rs:105-134, materials.rs:136-175), deterministic-sequence
    mode replaces the RNG like the reference's test hook (lights.rs:77-81).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.constants import EPSILON
from raytracer_tpu.core import types as T
from raytracer_tpu.core import intersect as I
from raytracer_tpu.core import shading as SH
from raytracer_tpu.core.patterns import pattern_color
from raytracer_tpu.ops.mesh_kernel import BLOCK_SIDE


def shadowed(scene: T.Scene, points, light_pos):
    """world.rs:101-111: nearest positive hit closer than the light and
    casting shadows (the reference checks only the NEAREST hit's shadow
    flag — a shadow:false object in front un-shadows)."""
    pos = jnp.broadcast_to(light_pos, points.shape)[:, None]  # [R,1,3]
    return I.shadow_blocked(scene, points, pos)[:, 0]


def _det_jitter_tables(static: T.SceneStatic, s_total, phase=0):
    """Deterministic jitter constants per sample (lights.rs:77-121 test hook).

    The reference cycles ONE global sequence shared by every area light:
    per shading point, ``intensity_at`` consumes 2 draws per sample in
    u-major order (u jitter then v jitter, lights.rs:105-117 inside the
    nested u/v loops of lights.rs:123-131), then ``lighting``'s area
    branch consumes 2 more per sample in the same order
    (materials.rs:139-142). This simulates that cycle exactly, for any
    sequence length, starting the shading point at cycle ``phase`` —
    the caller advances the phase by ``4 * samples`` per preceding area
    light, matching the shared iterator across the lights of one
    shade_hit (world.rs:66-76).

    Phase ACROSS shading points cannot be pinned: the reference renders
    pixels on a rayon pool with a thread-local iterator (camera.rs:66-84),
    so the per-pixel phase is schedule-dependent in the reference itself.
    Starting each shading point at phase 0 is the one reproducible choice
    and coincides with the reference wherever the cycle is phase-invariant
    (sequence length dividing 2, i.e. every reference test).
    """
    seq = static.jitter
    L = len(seq)

    def tab(off):
        return np.array(
            [seq[(phase + off + 2 * c) % L] for c in range(s_total)],
            np.float32,
        )

    return tab(0), tab(1), tab(2 * s_total), tab(2 * s_total + 1)


def _area_light_contrib(scene, ai, over, eyev, normalv, base_color, mat_rows,
                        key, live=None, jitter_phase=0):
    """Shadow fraction + sampled Phong for area light ``ai``.

    Everything stays in [R, S] form: the shadow trace goes through
    intersect.shadow_blocked (receiver transform factored out of the
    sample axis, no gid/u/v tables) and the Phong sum broadcasts
    [R, 1, ...] material rows against [R, S, 3] sample positions — XLA
    fuses the broadcasts instead of materializing [R*S, ...] copies.
    """
    st = scene.static
    us, vs = st.area_steps[ai]
    s_total = us * vs
    corner = scene.alight_corner[ai]
    uvec = scene.alight_uvec[ai]
    vvec = scene.alight_vvec[ai]
    intensity = scene.alight_intensity[ai]
    r = over.shape[0]

    uu = jnp.asarray(np.repeat(np.arange(us, dtype=np.float32), vs))  # [S]
    vv = jnp.asarray(np.tile(np.arange(vs, dtype=np.float32), us))
    deterministic = st.jitter is not None
    if deterministic:
        ju1, jv1, ju2, jv2 = (
            jnp.asarray(x)[None, :]
            for x in _det_jitter_tables(st, s_total, jitter_phase)
        )                                                    # [1, S]
    else:
        jj = jax.random.uniform(key, (r, s_total, 4))        # per-ray per-sample
        ju1, jv1, ju2, jv2 = jj[..., 0], jj[..., 1], jj[..., 2], jj[..., 3]

    # all u*v samples in ONE wide [R, S] trace + Phong batch (a scan
    # over samples serializes 100 tiny kernels; this is one wide one)
    def positions(ju, jv):
        return (
            corner
            + (uu[None, :] + ju)[..., None] * uvec
            + (vv[None, :] + jv)[..., None] * vvec
        )                                                    # [R|1, S, 3]

    sh = I.shadow_blocked(scene, over, positions(ju1, jv1), live=live)
    int_sum = jnp.sum(1.0 - sh.astype(jnp.float32), -1)      # [R]

    ds = SH.phong(
        mat_rows[:, None], base_color[:, None], intensity[None, None],
        positions(ju2, jv2), over[:, None], eyev[:, None], normalv[:, None],
    ).sum(1)                                                 # [R, 3]

    eff = base_color * intensity[None]
    ambient = eff * scene_mat_col(mat_rows, T.MAT_AMBIENT)
    frac = int_sum / s_total
    return ambient + (ds / s_total) * frac[:, None]


def scene_mat_col(mat_rows, col):
    return mat_rows[:, col : col + 1]


# Parked-ray sentinel: a ray at x=y=3e8 pointing +z has an empty slab
# interval against every scene AABB (x/y slabs collapse to -3e20 while the
# z slab sits near -3e8, so tmin > tmax), which kills the mesh chunk culls
# of the kernel and of both scans alike. Zero-weight and missed rays are
# parked so the mesh search skips them entirely.
PARK_ORIGIN = (3e8, 3e8, 3e8)
PARK_DIR = (0.0, 0.0, 1.0)


def park_rays(o, d, active):
    po = jnp.asarray(PARK_ORIGIN, o.dtype)
    pd = jnp.asarray(PARK_DIR, d.dtype)
    return (
        jnp.where(active[:, None], o, po),
        jnp.where(active[:, None], d, pd),
    )


def shade_level(scene: T.Scene, o, d, weight, key):
    """Trace + shade one wavefront level.

    Returns (weighted surface color [R,3], reflect spawn, refract spawn),
    each spawn = (origin, direction, child_weight).
    """
    st = scene.static
    if st.has_transparency and not st.all_ri_one:
        # the n1/n2 container walk needs the whole candidate table
        ts, gids, us, vs = I.candidate_hits(scene, o, d)
        has, t, gid, u, v, slot = I.first_hit(ts, gids, us, vs)
    else:
        # all_ri_one: every container's RI is 1.0, so the walk could
        # only ever return (1, 1) — the nearest hit suffices and the
        # refraction math below gets the constants (bit-identical to
        # running the walk, whose gathered values are exactly 1.0f)
        has, t, gid, u, v = I.nearest_hit(scene, o, d)
        ts = gids = slot = None
    gid = jnp.where(has, gid, 0)
    t = jnp.where(has, t, 1.0)

    point = o + t[:, None] * d
    eyev = -d
    # ONE tri->source row gather shared by every per-primitive attribute
    # (normals' transform, material id, pattern id): per-gid [G~1M]
    # attribute tables would turn each of these into its own large
    # gather. The per-source tables are then fetched through ONE one-hot
    # matmul against their concatenation — each separate table_gather
    # would materialize its own [R, Gc] one-hot.
    tgid = I.transform_row(scene, gid)
    g_c = scene.inv_tf.shape[0]
    src_tab = jnp.concatenate([
        scene.inv_tf.reshape(g_c, 16),
        scene.normal_mat.reshape(g_c, 9),
        scene.mat_id.astype(jnp.float32)[:, None],
        scene.pattern_id.astype(jnp.float32)[:, None],
    ], axis=1)                                       # [Gc, 27]
    rows = I.table_gather(src_tab, tgid)             # [R, 27]
    inv_rows = rows[:, :16].reshape(-1, 4, 4)
    nmat_rows = rows[:, 16:25].reshape(-1, 3, 3)
    mat_idx = rows[:, 25].astype(jnp.int32)
    pat_id = rows[:, 26].astype(jnp.int32)

    normalv = SH.normal_at(
        scene, gid, point, u, v, tgid=tgid, inv=inv_rows, nmat=nmat_rows
    )
    flip = jnp.sum(normalv * eyev, -1) < 0.0
    normalv = jnp.where(flip[:, None], -normalv, normalv)
    over = point + EPSILON * normalv
    under = point - EPSILON * normalv
    # missed rays trace no shadows: park their shading point so the mesh
    # culls reject it (their surface term is masked to 0 below anyway)
    over_sh, _ = park_rays(over, d, has)

    mat_rows = I.table_gather(scene.mat, mat_idx)
    pat = pattern_color(scene, gid, over, pid=pat_id, inv=inv_rows)
    has_pat = pat_id >= 0
    base_color = jnp.where(has_pat[:, None], pat, mat_rows[:, T.MAT_COLOR])

    surface = jnp.zeros_like(base_color)
    n_point = scene.plight_pos.shape[0]
    for li in range(n_point):
        lpos = scene.plight_pos[li]
        lint = scene.plight_intensity[li]
        blocked = I.shadow_blocked(
            scene, over_sh,
            jnp.broadcast_to(lpos, (over_sh.shape[0], 1, 3)), live=has,
        )[:, 0]
        inten = jnp.where(blocked, 0.0, 1.0)
        eff = base_color * lint[None]
        ambient = eff * scene_mat_col(mat_rows, T.MAT_AMBIENT)
        ds = SH.phong(mat_rows, base_color, lint[None], lpos[None], over, eyev, normalv)
        surface = surface + ambient + ds * inten[:, None]

    jitter_phase = 0  # the shared cycle advances 4*S per area light
    for ai in range(len(st.area_steps)):
        lkey = jax.random.fold_in(key, 7919 + ai) if key is not None else None
        surface = surface + _area_light_contrib(
            scene, ai, over_sh, eyev, normalv, base_color, mat_rows, lkey,
            live=has, jitter_phase=jitter_phase,
        )
        jitter_phase += 4 * st.area_steps[ai][0] * st.area_steps[ai][1]

    surface = jnp.where(has[:, None], surface, 0.0)

    # --- secondary rays ---------------------------------------------------
    if st.has_transparency and not st.all_ri_one:
        n1, n2 = SH.refraction_indices_fast(scene, ts, gids, slot)
    else:
        n1 = n2 = jnp.ones_like(t)

    reflective = mat_rows[:, T.MAT_REFLECTIVE]
    transparency = mat_rows[:, T.MAT_TRANSPARENCY]
    blend = (reflective > 0.0) & (transparency > 0.0)
    r_schlick = SH.schlick(eyev, normalv, n1, n2)
    refl_factor = jnp.where(blend, r_schlick, 1.0)
    refr_factor = jnp.where(blend, 1.0 - r_schlick, 1.0)

    n_lights = float(n_point + len(st.area_steps))
    reflectv = SH.reflect(d, normalv)
    w_reflect = weight * jnp.where(
        has, reflective * refl_factor * n_lights, 0.0
    )[:, None]

    n_ratio = n1 / n2
    cos_i = jnp.sum(eyev * normalv, -1)
    sin2_t = n_ratio * n_ratio * (1.0 - cos_i * cos_i)
    tir = sin2_t > 1.0
    cos_t = jnp.sqrt(jnp.maximum(1.0 - sin2_t, 1e-10))
    refr_dir = (n_ratio * cos_i - cos_t)[:, None] * normalv - n_ratio[:, None] * eyev
    # Unlike reflection, Snell's construction does not preserve length;
    # downstream shading (Schlick cos, Phong rde^shininess) assumes unit
    # directions — a 1.5x-length eyev overflows rde^300 to inf in f32.
    refr_dir = refr_dir / jnp.maximum(
        jnp.linalg.norm(refr_dir, axis=-1, keepdims=True), 1e-12
    )
    w_refract = weight * jnp.where(
        has & ~tir, transparency * refr_factor * n_lights, 0.0
    )[:, None]

    return (
        weight * surface,
        (over, reflectv, w_reflect),
        (under, refr_dir, w_refract),
    )


def _packed_shade_level(scene: T.Scene, o, d, w, key, *, thread_perm=False):
    """shade_level with live rays compacted to the front, run at the
    narrowest width (R, R/2, R/4, R/16) that holds them.

    Deep wavefront levels are mostly parked, but every dense [R, ...]
    op (static trace, candidate table, gathers, Phong) still costs full
    width. Per-ray results are independent of batch order and grouping
    (the mesh search's gates are conservative), so a stable
    live-first permutation + a narrower batch is EXACT; the tail is
    parked padding. Branch selection is a lax.cond chain, so each tile
    pays only for the width its level actually needs.

    ``thread_perm``: return results IN SORTED ORDER plus the sort
    permutation instead of un-permuting (7 full-width [R, 3] gathers
    per level). The caller threads
    the composed permutation through the levels (color_at) and
    un-permutes the accumulated image once per tile.
    """
    r = o.shape[0]
    live = jnp.any(w > 0.0, -1)
    n_live = jnp.sum(live.astype(jnp.int32))
    # Live-first stable key: a tile's secondary origins are already
    # screen-local, so live rays keep tight block frusta in this order.
    order = jnp.argsort(jnp.where(live, 0, 1).astype(jnp.int8), stable=True)
    o_s, d_s, w_s = o[order], d[order], w[order]
    po = jnp.asarray(PARK_ORIGIN, o.dtype)
    pd = jnp.asarray(PARK_DIR, d.dtype)
    inv_order = None if thread_perm else jnp.argsort(order)

    def run(width):
        def branch(_):
            colored, refl, refr = shade_level(
                scene, o_s[:width], d_s[:width], w_s[:width], key
            )

            def pad(x, fill):
                if width == r:
                    return x
                tail = jnp.broadcast_to(fill, (r - width, 3)).astype(x.dtype)
                return jnp.concatenate([x, tail], 0)

            zero = jnp.zeros(3, colored.dtype)
            out = [pad(colored, zero)]
            for so, sd, sw in (refl, refr):
                out += [pad(so, po), pad(sd, pd), pad(sw, zero)]
            if thread_perm:
                return tuple(out)
            # undo the live-first permutation
            return tuple(x[inv_order] for x in out)

        return branch

    args = ()
    parts = jax.lax.cond(
        n_live <= r // 16,
        run(r // 16),
        lambda a: jax.lax.cond(
            n_live <= r // 4,
            run(r // 4),
            lambda a: jax.lax.cond(n_live <= r // 2, run(r // 2), run(r), a),
            a,
        ),
        args,
    )
    out = parts[0], tuple(parts[1:4]), tuple(parts[4:7])
    return out + (order,) if thread_perm else out


def color_at(scene: T.Scene, origins, directions, key=None, limit=None,
             *, remat=False):
    """world.rs:91-99 over a ray batch, bounce tree unrolled.

    ``remat=True`` wraps every bounce level in :func:`jax.checkpoint` so
    reverse-mode autodiff recomputes the level's trace instead of storing
    its residuals. A blend scene's level width grows to ``2^depth * R``
    (16R at the default depth 4), and storing every level's intermediates
    multiplies a train step's memory by that width. With per-level remat
    only the level *inputs* (o, d, w: 3 arrays) live across the backward
    pass, bounding grad memory by the widest single level's forward.
    Identity for forward-only evaluation (remat changes vjp only).
    """
    st = scene.static
    if limit is None:
        limit = st.recursion_limit
    r = origins.shape[0]
    img = jnp.zeros((r, 3))

    ckpt = jax.checkpoint if remat else (lambda f: f)

    o, d = origins, directions
    w = jnp.ones((r, 3))
    # Composed live-first permutation (slot -> original ray row): packed
    # levels keep their outputs SORTED and the image accumulator follows
    # the current order; one argsort+gather per tile at the end replaces
    # 7 full-width un-permute gathers per level. Only sound while the
    # level width stays r (merged or single spawn streams — has_blend
    # concatenation doubles widths and keeps the legacy un-permute).
    perm = None
    for level in range(limit + 1):
        lkey = jax.random.fold_in(key, level) if key is not None else None
        if level == 0:
            colored, refl, refr = ckpt(shade_level)(scene, o, d, w, lkey)
        else:
            # Whole-level skip: once every ray of this tile is parked
            # (zero weight), the level's FIXED costs — static-family
            # trace, shadow query, gathers, n1/n2 walk — are pure waste.
            # Exact: a parked level contributes 0 and spawns only
            # zero-weight children. Partially-live levels additionally
            # compact + narrow (_packed_shade_level) where the per-level
            # fixed costs are worth a sort: mesh scenes (trace + gathers)
            # and area-light scenes (the [R, S] shadow/Phong sample
            # math). Blend-y small scenes keep their levels mostly live,
            # and without thread_perm (unsound across concatenated
            # widths) every packed level would pay a multi-million-row
            # argsort plus 7 full-width un-permute gathers.
            pack = (
                (st.counts[5] - st.n_csg_tris > 20000 or st.area_steps)
                and o.shape[0] >= 4096
                and o.shape[0] % 16 == 0
            )
            thread_perm = pack and not st.has_blend

            def _level(scene, o, d, w, lkey):
                def _live(args):
                    sc, *rest = args
                    if pack:
                        return _packed_shade_level(
                            sc, *rest, thread_perm=thread_perm
                        )
                    return shade_level(sc, *rest)

                def _dead(args):
                    _, o_, d_, w_, _k = args
                    z = jnp.zeros_like(w_)
                    out = (z, (o_, d_, z), (o_, d_, z))
                    if thread_perm:
                        out += (jnp.arange(o_.shape[0], dtype=jnp.int32),)
                    return out

                return jax.lax.cond(
                    jnp.any(w > 0.0), _live, _dead, (scene, o, d, w, lkey)
                )

            result = ckpt(_level)(scene, o, d, w, lkey)
            if thread_perm:
                colored, refl, refr, order = result
                perm = order if perm is None else perm[order]
                # image follows the current slot order; the spawn merge
                # below consumes refl/refr in that same order
                img = img[order] + colored
                colored = None
            else:
                colored, refl, refr = result
        if colored is not None:
            img = img + colored.reshape(-1, r, 3).sum(0)
        if level == limit:
            break
        spawns = []
        if st.has_reflective:
            spawns.append(refl)
        if st.has_transparency:
            spawns.append(refr)
        if not spawns:
            break
        if len(spawns) == 2 and not st.has_blend:
            # No material is both reflective and transparent, so the two
            # spawn weights are disjoint per ray (reflection XOR
            # refraction) — select instead of concatenate and the level
            # width stays R for every depth instead of doubling. Exact:
            # the dropped stream's weight is identically zero.
            (ro, rd, rw), (fo, fd, fw) = spawns
            take_r = jnp.any(rw > 0.0, -1, keepdims=True)
            o = jnp.where(take_r, ro, fo)
            d = jnp.where(take_r, rd, fd)
            w = rw + fw
        else:
            o = jnp.concatenate([s[0] for s in spawns], 0)
            d = jnp.concatenate([s[1] for s in spawns], 0)
            w = jnp.concatenate([s[2] for s in spawns], 0)
        # park zero-weight spawns: deep levels are mostly dead weight
        # (only reflective/transparent hit points spawn), and parked rays
        # cost the mesh path nothing
        o, d = park_rays(o, d, jnp.any(w > 0.0, -1))
    if perm is not None:
        # undo the composed live-first permutation once per tile
        img = img[jnp.argsort(perm)]
    return img


@functools.partial(jax.jit, static_argnames=("limit",))
def _color_at_jit(scene, origins, directions, key, limit):
    return color_at(scene, origins, directions, key, limit)


def tile_rays(inv, consts, idx, hsize: int):
    """Primary rays for flat pixel ids, on device (camera.rs:45-64 math).

    inv: [4,4] inverse camera transform; consts: [3] = (half_width,
    half_height, pixel_size); idx: [R] i32 flat pixel ids (py*hsize+px).
    Returns (origins [R,3], directions [R,3]). Shared by the frame scan
    and the resumable per-tile renderer so both produce identical rays.
    """
    half_w, half_h, psize = consts[0], consts[1], consts[2]
    origin = inv[:3, 3]
    pxf = (idx % hsize).astype(jnp.float32)
    pyf = (idx // hsize).astype(jnp.float32)
    wx = half_w - (pxf + 0.5) * psize
    wy = half_h - (pyf + 0.5) * psize
    ph = jnp.stack([wx, wy, jnp.full_like(wx, -1.0), jnp.ones_like(wx)], -1)
    pw = jnp.einsum("rj,ij->ri", ph, inv, precision="highest")
    d = pw[:, :3] - origin
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.broadcast_to(origin, d.shape), d


def camera_consts(camera):
    """(inv [4,4], consts [3]) device args of :func:`tile_rays`."""
    inv = jnp.asarray(np.linalg.inv(camera.transform), jnp.float32)
    consts = jnp.asarray(
        [camera.half_width, camera.half_height, camera.pixel_size],
        jnp.float32,
    )
    return inv, consts


@functools.partial(jax.jit, static_argnames=("limit", "hsize"))
def _tile_color_jit(scene, inv, consts, idx, key, limit, hsize):
    o, d = tile_rays(inv, consts, idx, hsize)
    return color_at(scene, o, d, key, limit)


@functools.partial(jax.jit, static_argnames=("limit", "quantize", "hsize"))
def _render_frame_jit(scene, inv, consts, idx_tiles, keys, limit, quantize,
                      hsize):
    """A segment of the frame's tiles in ONE dispatch: lax.scan over the
    tile axis. Scan bodies are traced once and executed per iteration
    (not vmapped), so each tile keeps its own mesh culling; render()
    splits the frame into a handful of equal segments so that each
    segment's device->host copy overlaps the next segment's compute.

    Primary rays are generated IN the scan body from the inverse camera
    matrix (camera.rs:45-64 math) and the pixel-id tiles: the host ships
    4 bytes per ray instead of 24.

    inv: [4,4] inverse camera transform; consts: [3] =
    (half_width, half_height, pixel_size); idx_tiles: [n_tiles, tile]
    i32 flat pixel ids (block-major order, padding repeats id 0);
    keys: [n_tiles, keydim] per-tile PRNG keys (split on the host so
    the segmentation cannot change the stream).
    """

    def body(carry, xs):
        idx, k = xs
        o, d = tile_rays(inv, consts, idx, hsize)
        return carry, color_at(scene, o, d, k, limit)

    _, out = jax.lax.scan(body, None, (idx_tiles, keys))
    if quantize:
        # canvas.quantize_u8 bit-exact (clamp + round-half-away-from-zero
        # in f32), on device: the frame crosses to the host as u8
        out = jnp.floor(jnp.clip(out, 0.0, 1.0) * 255.0 + 0.5).astype(jnp.uint8)
    return out


def _block_order(h, w, block=BLOCK_SIDE):
    """Flat pixel indices in square-block-major order: each consecutive
    ``block * block`` ids form one pixel square. The mesh kernel takes
    its rays in runs of exactly that many (ops/mesh_kernel.BR), so each
    of its programs culls over one screen-local frustum (a row-major run
    spans the image width and defeats AABB rejection). Independent of
    the dispatch tile size, which only sets the lax.scan granularity."""
    block = max(min(block, h, w), 1)
    cols = []
    for y0 in range(0, h, block):
        for x0 in range(0, w, block):
            ys = np.arange(y0, min(y0 + block, h))
            xs = np.arange(x0, min(x0 + block, w))
            cols.append((ys[:, None] * w + xs[None, :]).ravel())
    return np.concatenate(cols)


# (device, h, w, tile) -> (host order [n], device idx_tiles [n_tiles, tile]
# i32). The pixel-id tiles are camera-pose independent, so one small
# transfer serves every frame at that resolution on that device.
_ORDER_CACHE = {}


def _order_tiles(h, w, tile):
    key = (str(jax.config.jax_default_device), h, w, tile)
    got = _ORDER_CACHE.get(key)
    if got is None:
        order = _block_order(h, w)
        n = h * w
        n_pad = -n % tile
        padded = np.pad(order, (0, n_pad)) if n_pad else order
        idx_tiles = jax.device_put(
            jnp.asarray(padded.reshape(-1, tile), jnp.int32)
        )
        got = (order, idx_tiles)
        _ORDER_CACHE[key] = got
    return got


def pick_tile_rays(static: T.SceneStatic) -> int:
    """Adaptive rays-per-dispatch (= the lax.scan iteration width).

    Mesh-culling quality does not depend on this (kernel blocks are fixed
    pixel squares, see _block_order), so the tile size trades scan
    iterations (each with a fixed dispatch overhead) against the working
    set of [R, C] intermediates and the packed deep-level widths. The
    values come from sweeps on an earlier accelerator and are still to be
    re-measured on the GPU. Area-light scenes keep a smaller tile: their
    shadow/Phong math materializes [R, S~100, 3] sample intermediates;
    blend scenes grow deep levels to 16R by spawn concatenation."""
    n_free_tris = static.counts[5] - static.n_csg_tris
    if static.area_steps:
        return 1 << 12 if static.csg_nodes else 1 << 14
    if static.has_blend:
        return 1 << 14
    return 1 << 14 if n_free_tris > 20000 else 1 << 17


def render(scene: T.Scene, camera, *, key=None, tile_rays=None,
           quantize=False):
    """Full frame -> float32 [vsize, hsize, 3] numpy image.

    ``quantize=True`` returns uint8 instead, quantized ON DEVICE with the
    exact :func:`canvas.quantize_u8` formula — bit-identical PPM output at
    a quarter of the device->host transfer. Use it when the image goes
    straight to PPM (no float post-processing such as dithering)."""
    if key is None:
        key = jax.random.PRNGKey(0)
    if tile_rays is None:
        tile_rays = pick_tile_rays(scene.static)
    # Pin the scene tables on device once instead of once per dispatch.
    scene = jax.device_put(scene)
    n = camera.vsize * camera.hsize
    tile = min(tile_rays, n)

    order, idx_tiles = _order_tiles(camera.vsize, camera.hsize, tile)
    inv, consts = camera_consts(camera)
    limit = scene.static.recursion_limit
    n_tiles = idx_tiles.shape[0]
    keys = jax.random.split(key, n_tiles)
    # Segment the frame so each segment's device->host copy rides under
    # the next segment's compute (whether this still pays on the GPU is
    # an open measurement). Equal segment sizes keep it to at most two
    # compiled program shapes (body + remainder).
    seg = -(-n_tiles // 6)
    outs = []
    for i0 in range(0, n_tiles, seg):
        out = _render_frame_jit(
            scene, inv, consts, idx_tiles[i0:i0 + seg], keys[i0:i0 + seg],
            limit, quantize, camera.hsize,
        )
        out.copy_to_host_async()
        outs.append(out)
    img = np.concatenate(
        [np.asarray(o).reshape(-1, 3) for o in outs]
    )[:n]
    out = np.empty_like(img)
    out[order] = img
    return out.reshape(camera.vsize, camera.hsize, 3)

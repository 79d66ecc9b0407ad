"""Compile host-side specs into the device SoA Scene.

Group flattening: the reference walks parent chains at render time
(shapes.rs:272-292, groups.rs:127-133). We compose each leaf's full affine
chain once here, so the device never sees a tree. For affine transforms the
composition is exact (see core/types.py docstring).

CSG encoding: nodes are numbered bottom-up (children before parents); every
leaf primitive records, per ancestor node bit, whether it sits in that
node's left subtree. The device-side filter (core/csg.py) then reproduces
csg.rs:26-123 with parity prefix-sums.
"""

from __future__ import annotations

import jax
import numpy as np

from raytracer_tpu.core import types as T
from raytracer_tpu.ops.mesh_kernel import pack_planes
from raytracer_tpu.scene import specs as S

_DEF_UV = -1


def _det_eps(m: np.ndarray) -> float:
    """Per-instance Moller-Trumbore det threshold (see types.Scene
    .tri_det_eps): the reference tests |det| < EPSILON in OBJECT space
    (triangle.rs:96) and det_obj = det_world / det(A) for the instance's
    linear part A, so the world-space test is |det_world| < EPS*|det A|.
    Computed in f64 at build; floored away from 0 so a degenerate
    transform can't turn the test into 'accept det==0'."""
    from raytracer_tpu.constants import EPSILON

    d = abs(float(np.linalg.det(np.asarray(m, np.float64)[:3, :3])))
    return max(EPSILON * d, 1e-30)


def _morton_keys(w: np.ndarray) -> np.ndarray:
    """Vectorized Morton codes of world-space points [N, 3]."""
    # quantize into a fixed [-64, 64) world window (plenty for the book
    # scenes; out-of-window triangles clamp — ordering only affects perf)
    q = ((w + 64.0) * (1024.0 / 128.0)).astype(np.int64)
    q = np.minimum(np.maximum(q, 0), 1023)  # int np.clip is ~10x slower

    def spread(v):
        v = v & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


def build_scene(
    items: list,
    *,
    jitter: tuple | None = None,
    recursion_limit: int = 4,
) -> T.Scene:
    """items: shapes / Groups / Csgs / PointLights / AreaLights."""
    b = _Builder()
    for item in items:
        if isinstance(item, S.PointLight):
            b.point_lights.append(item)
        elif isinstance(item, S.AreaLight):
            b.area_lights.append(item)
        elif isinstance(item, S.Group):
            b.add_group(item, np.eye(4, dtype=np.float32))
        elif isinstance(item, S.Csg):
            b.add_csg_root(item)
        else:
            b.add_shape(item, item.matrix, 0, 0)
    return b.finish(jitter=jitter, recursion_limit=recursion_limit)


class _Builder:
    def __init__(self):
        self.rows = {name: [] for name in T.FAMILIES}
        self.point_lights = []
        self.area_lights = []
        self.mesh_blocks = []  # array-backed triangle blocks (S.Mesh)
        self.csg_nodes = []  # (op_code, bit, root_bit)
        self._csg_bit = 0
        # pattern / uv / image tables
        self.patterns = []
        self.uvs = []
        self.images = []

    # --- shapes -----------------------------------------------------------

    def add_group(self, group: S.Group, parent_m: np.ndarray):
        m = parent_m @ group.matrix
        for child in group.children:
            if isinstance(child, S.Group):
                self.add_group(child, m)
            else:
                self.add_shape(child, m @ child.matrix, 0, 0)

    def add_csg_root(self, root: S.Csg):
        self._add_csg_node(root, under=0, left=0, root_bit=None)

    def _add_csg_node(self, node: S.Csg, under: int, left: int, root_bit):
        # Children first so the node list is bottom-up; but the node's bit
        # must exist before leaves record membership -> allocate bit now,
        # emit the node entry after recursing.
        bit = self._csg_bit
        self._csg_bit += 1
        if self._csg_bit > 64:
            # membership masks are uint64 words (csg.py); the reference's
            # recursion is unbounded (csg.rs:26-49) but no sample scene
            # exceeds 5 nodes — see ARCHITECTURE.md "CSG encoding"
            raise ValueError(
                "At most 64 CSG nodes per scene supported "
                "(uint64 membership masks; see ARCHITECTURE.md)"
            )
        my_root = bit if root_bit is None else root_bit
        op = {"union": T.CSG_UNION, "intersect": T.CSG_INTERSECT,
              "difference": T.CSG_DIFFERENCE}[node.op]

        for side, child in (("L", node.left), ("R", node.right)):
            cu = under | (1 << bit)
            cl = left | ((1 << bit) if side == "L" else 0)
            if isinstance(child, S.Csg):
                self._add_csg_node(child, cu, cl, my_root)
            else:
                self.add_shape(child, child.matrix, cu, cl)
        self.csg_nodes.append((op, bit, my_root))

    def add_shape(self, shape, world_m: np.ndarray, csg_under: int, csg_left: int):
        mat_row, pattern_id = self._material(shape.material)
        common = dict(
            m=np.asarray(world_m, np.float32),
            mat=mat_row,
            pattern_id=pattern_id,
            shadow=bool(shape.shadow),
            csg_under=csg_under,
            csg_left=csg_left,
        )
        if isinstance(shape, S.Sphere):
            self.rows["sphere"].append(common)
        elif isinstance(shape, S.Plane):
            self.rows["plane"].append(common)
        elif isinstance(shape, S.Cube):
            self.rows["cube"].append(common)
        elif isinstance(shape, S.Cylinder):
            common.update(min=shape.min, max=shape.max, closed=shape.closed)
            self.rows["cylinder"].append(common)
        elif isinstance(shape, S.Cone):
            common.update(min=shape.min, max=shape.max, closed=shape.closed)
            self.rows["cone"].append(common)
        elif isinstance(shape, S.Mesh):
            if csg_under:
                raise ValueError("Mesh blocks cannot be CSG leaves")
            self.mesh_blocks.append(dict(
                m=common["m"], p=shape.p, n=shape.n, smooth=shape.smooth,
                mat=common["mat"], pattern_id=common["pattern_id"],
                shadow=common["shadow"],
            ))
        elif isinstance(shape, (S.Triangle, S.SmoothTriangle)):
            smooth = isinstance(shape, S.SmoothTriangle)
            common.update(
                p=(shape.p1, shape.p2, shape.p3),
                n=(shape.n1, shape.n2, shape.n3) if smooth else None,
                smooth=smooth,
            )
            self.rows["triangle"].append(common)
        else:
            raise TypeError(f"Unknown shape spec: {type(shape)}")

    # --- materials / patterns ----------------------------------------------

    def _material(self, mat: S.Material):
        row = np.zeros(T.MAT_NCOLS, np.float32)
        row[T.MAT_COLOR] = mat.color
        row[T.MAT_AMBIENT] = mat.ambient
        row[T.MAT_DIFFUSE] = mat.diffuse
        row[T.MAT_SPECULAR] = mat.specular
        row[T.MAT_SHININESS] = mat.shininess
        row[T.MAT_REFLECTIVE] = mat.reflective
        row[T.MAT_TRANSPARENCY] = mat.transparency
        row[T.MAT_REFRACTIVE] = mat.refractive_index
        pattern_id = -1 if mat.pattern is None else self._pattern(mat.pattern)
        return row, pattern_id

    def _pattern(self, p: S.Pattern) -> int:
        kind = {
            "striped": T.PAT_STRIPED, "gradient": T.PAT_GRADIENT,
            "ring": T.PAT_RING, "checker": T.PAT_CHECKER,
            "xyz_rgb": T.PAT_XYZRGB, "texture_map": T.PAT_TEXTURE,
            "cube_map": T.PAT_CUBEMAP,
        }[p.kind]
        m = S._as_matrix(p.transform)
        uv_ids = [_DEF_UV] * 6
        if p.kind == "texture_map":
            uv_ids[0] = self._uv(p.uv_pattern)
        elif p.kind == "cube_map":
            faces = (p.left, p.right, p.front, p.back, p.up, p.down)
            uv_ids = [self._uv(f) for f in faces]
        mapping = {"spherical": T.MAP_SPHERICAL, "planar": T.MAP_PLANAR,
                   "cylindrical": T.MAP_CYLINDRICAL}[p.mapping]
        self.patterns.append(dict(
            kind=kind, a=p.a, b=p.b, inv=np.linalg.inv(m).astype(np.float32),
            mapping=mapping, uv=uv_ids,
        ))
        return len(self.patterns) - 1

    def _uv(self, uv: S.UvPatternSpec) -> int:
        kind = {"checker": T.UV_CHECKER, "align_check": T.UV_ALIGN,
                "image": T.UV_IMAGE}[uv.kind]
        colors = np.zeros((5, 3), np.float32)
        image_id = -1
        if uv.kind == "checker":
            colors[0], colors[1] = uv.a, uv.b
        elif uv.kind == "align_check":
            colors[0], colors[1], colors[2], colors[3], colors[4] = (
                uv.main, uv.ul, uv.ur, uv.bl, uv.br)
        else:
            image_id = len(self.images)
            self.images.append(np.asarray(uv.image, np.float32))
        self.uvs.append(dict(kind=kind, w=uv.width, h=uv.height,
                             colors=colors, image=image_id))
        return len(self.uvs) - 1

    # --- finish -----------------------------------------------------------

    def _triangle_batches(self):
        """Unified per-triangle arrays from individual rows + mesh blocks,
        with the geometry already in world space.

        World transforms and normal-matrix products run per SOURCE (one
        GEMM per mesh block) — materializing a per-triangle [Nt,4,4]
        matrix table and einsum-ing it would dominate a 1M-triangle scene
        build. Returns a dict of arrays: w [Nt,3,3] world corners,
        n_world [Nt,3,3] world-space (unnormalized) vertex normals,
        flat [Nt,3] unit world flat normals, smooth [Nt], mat
        [Nt,NCOLS], pattern_id [Nt], shadow [Nt], csg_under [Nt],
        csg_left [Nt], tf_id [Nt]; plus src_m [n_tf,4,4] source
        matrices. Individual CSG rows come first (dense candidate
        columns need them leading).
        """

        def world_geometry(p, n, smooth, m):
            """World corners / vertex normals / flat normal for one
            source matrix m (triangle.rs:32-48 flat-normal semantics:
            object-space normalize(e2 x e1), then the normal matrix,
            then a final normalize)."""
            rot = np.ascontiguousarray(m[:3, :3], np.float32)
            trans = m[:3, 3].astype(np.float32)
            nm = np.linalg.inv(m.astype(np.float64)).T[:3, :3].astype(np.float32)
            nt = p.shape[0]
            w = (p.reshape(-1, 3) @ rot.T + trans).reshape(nt, 3, 3)
            e1o = p[:, 1] - p[:, 0]
            e2o = p[:, 2] - p[:, 0]
            n_obj = np.cross(e2o, e1o)
            n_obj /= np.maximum(
                np.linalg.norm(n_obj, axis=-1, keepdims=True), 1e-30
            )
            flat = n_obj @ nm.T
            flat /= np.maximum(
                np.linalg.norm(flat, axis=-1, keepdims=True), 1e-30
            )
            # np.where with a [n,1,1] broadcast mask hits a ~30x-slow
            # numpy path on [n,3,3] operands; explicit boolean-index
            # assignment is a plain memcpy per side.
            n_world = np.repeat(
                flat[:, None, :], 3, axis=1
            ).astype(np.float32, copy=False)
            if smooth.any():
                sm_n = (n[smooth].reshape(-1, 3) @ nm.T).reshape(-1, 3, 3)
                n_world[smooth] = sm_n
            return w.astype(np.float32), n_world, flat.astype(np.float32)

        batches = []
        src_ms = []
        rows = sorted(
            self.rows["triangle"], key=lambda r: 0 if r["csg_under"] else 1
        )
        for i, r in enumerate(rows):
            m = np.asarray(r["m"], np.float64)
            p = np.asarray(r["p"], np.float32)[None]
            n = (np.asarray(r["n"], np.float32)
                 if r["smooth"] else np.zeros((3, 3), np.float32))[None]
            smooth = np.array([bool(r["smooth"])])
            w, n_world, flat = world_geometry(p, n, smooth, m)
            src_ms.append(m)
            batches.append(dict(
                w=w, n_world=n_world, flat=flat, smooth=smooth,
                det_eps=np.full(1, _det_eps(m), np.float32),
                mat_src=r["mat"],
                pattern_id=np.array([r["pattern_id"]], np.int32),
                shadow=np.array([r["shadow"]], bool),
                csg_under=np.array([r["csg_under"]], np.uint64),
                csg_left=np.array([r["csg_left"]], np.uint64),
                tf_id=np.array([i], np.int32),
            ))
        n_rows = len(rows)
        for bi, blk in enumerate(self.mesh_blocks):
            n = blk["p"].shape[0]
            m = np.asarray(blk["m"], np.float64)
            w, n_world, flat = world_geometry(
                np.asarray(blk["p"], np.float32),
                np.asarray(blk["n"], np.float32),
                blk["smooth"], m,
            )
            src_ms.append(m)
            batches.append(dict(
                w=w, n_world=n_world, flat=flat, smooth=blk["smooth"],
                det_eps=np.full(n, _det_eps(m), np.float32),
                mat_src=blk["mat"],
                pattern_id=np.full(n, blk["pattern_id"], np.int32),
                shadow=np.full(n, blk["shadow"], bool),
                csg_under=np.zeros(n, np.uint64),
                csg_left=np.zeros(n, np.uint64),
                # all triangles of a mesh block share one transform row
                tf_id=np.full(n, n_rows + bi, np.int32),
            ))
        if not batches:
            return None
        keys = ("w", "n_world", "flat", "smooth", "det_eps", "pattern_id",
                "shadow", "csg_under", "csg_left", "tf_id")
        out = {k: np.concatenate([b[k] for b in batches]) for k in keys}
        out["src_m"] = np.stack(src_ms)
        out["mat_src"] = np.stack([b["mat_src"] for b in batches])
        # per-SOURCE attributes (tf_id order): every triangle of a batch
        # shares them, so the device tables need one row per source
        out["src_pattern_id"] = np.array(
            [int(b["pattern_id"][0]) for b in batches], np.int32)
        out["src_shadow"] = np.array(
            [bool(b["shadow"][0]) for b in batches], bool)
        return out

    def finish(self, *, jitter, recursion_limit) -> T.Scene:
        tb = self._triangle_batches()
        nt = 0 if tb is None else tb["w"].shape[0]
        n_csg_tris = 0 if tb is None else int((tb["csg_under"] != 0).sum())

        if tb is not None:
            w = tb["w"]
            # Morton-order the free triangles by world-space centroid so
            # the renderer's fixed-size scan chunks are spatially tight —
            # that's what makes chunk-AABB culling effective (the
            # BVH-equivalent of groups.rs:284-299 for a wide-SIMD machine)
            if nt - n_csg_tris > 2:
                keys = _morton_keys(w[n_csg_tris:].mean(axis=1))
                order = np.concatenate([
                    np.arange(n_csg_tris),
                    n_csg_tris + np.argsort(keys, kind="stable"),
                ])
                tb = {
                    k: (v if k in ("src_m", "mat_src", "src_pattern_id",
                "src_shadow") else v[order])
                    for k, v in tb.items()
                }
                w = tb["w"]

        counts = tuple(
            len(self.rows[f]) if f != "triangle" else nt for f in T.FAMILIES
        )
        all_rows = [
            r for f in T.FAMILIES if f != "triangle" for r in self.rows[f]
        ]
        g_nt = len(all_rows)          # non-triangle gid count
        g = g_nt + nt

        # Materials dedup at SOURCE granularity: non-triangle rows plus one
        # row per triangle source. np.unique(axis=0) over the old per-gid
        # [G, NCOLS] table sorted a million rows (~10 s of a dragons-scale
        # build) to discover what the sources already knew.
        mat_rows_nt = (
            np.stack([r["mat"] for r in all_rows]).astype(np.float32)
            if all_rows else np.zeros((0, T.MAT_NCOLS), np.float32)
        )
        mat_src = (
            tb["mat_src"].astype(np.float32) if tb is not None
            else np.zeros((0, T.MAT_NCOLS), np.float32)
        )
        all_mat = np.concatenate([mat_rows_nt, mat_src])
        if not len(all_mat):
            all_mat = np.zeros((1, T.MAT_NCOLS), np.float32)
        mat_table, src_mat_id = np.unique(all_mat, axis=0, return_inverse=True)
        src_mat_id = src_mat_id.reshape(-1).astype(np.int32)
        # non-triangle rows + one row per triangle SOURCE (individual
        # triangle or mesh block) — see types.Scene.inv_tf; the attribute
        # tables below share this compact indexing
        n_tf = 0 if tb is None else int(tb["tf_id"].max()) + 1
        gc = max(g_nt + n_tf, 1)
        mat_id = np.zeros(gc, np.int32)
        if g_nt or n_tf:
            mat_id[: g_nt + n_tf] = src_mat_id
        pattern_id = np.full(gc, -1, np.int32)
        shadow = np.ones(gc, bool)
        inv_tf = np.tile(np.eye(4, dtype=np.float32), (max(g_nt + n_tf, 1), 1, 1))
        normal_mat = np.tile(np.eye(3, dtype=np.float32), (max(g_nt + n_tf, 1), 1, 1))
        csg_members = []

        if g_nt:
            pattern_id[:g_nt] = [r["pattern_id"] for r in all_rows]
            shadow[:g_nt] = [r["shadow"] for r in all_rows]
            m_all = np.stack([r["m"] for r in all_rows]).astype(np.float64)
            inv_all = np.linalg.inv(m_all).astype(np.float32)  # batched
            inv_tf[:g_nt] = inv_all
            normal_mat[:g_nt] = inv_all.transpose(0, 2, 1)[:, :3, :3]
        for i, r in enumerate(all_rows):
            if r["csg_under"]:
                csg_members.append((i, int(r["csg_under"]), int(r["csg_left"])))

        # cylinders / cones
        def _mm(fam):
            rows = self.rows[fam]
            mn = np.array([r["min"] for r in rows], np.float32)
            mx = np.array([r["max"] for r in rows], np.float32)
            cl = np.array([r["closed"] for r in rows], bool)
            return mn, mx, cl

        cyl_min, cyl_max, cyl_closed = _mm("cylinder")
        cone_min, cone_max, cone_closed = _mm("cone")

        # triangles (already world-space; see _triangle_batches)
        if nt:
            pattern_id[g_nt : g_nt + n_tf] = tb["src_pattern_id"]
            shadow[g_nt : g_nt + n_tf] = tb["src_shadow"]
            inv_src = np.linalg.inv(tb["src_m"]).astype(np.float32)
            inv_tf[g_nt : g_nt + n_tf] = inv_src
            normal_mat[g_nt : g_nt + n_tf] = inv_src.transpose(0, 2, 1)[:, :3, :3]
            for i in np.nonzero(tb["csg_under"])[0]:
                csg_members.append((
                    g_nt + int(i), int(tb["csg_under"][i]), int(tb["csg_left"][i])
                ))

            tri_p1 = np.ascontiguousarray(w[:, 0])
            tri_e1 = w[:, 1] - w[:, 0]
            tri_e2 = w[:, 2] - w[:, 0]
            # n_world already holds the flat normal for non-smooth rows
            n_world = tb["n_world"]
            tri_shade = np.concatenate(
                [n_world[:, 0], n_world[:, 1], n_world[:, 2], tb["flat"],
                 tb["smooth"][:, None].astype(np.float32)],
                axis=1,
            ).astype(np.float32)
            tri_tf_id = tb["tf_id"].astype(np.int32)
            tri_det_eps = tb["det_eps"].astype(np.float32)
        else:
            tri_p1 = tri_e1 = tri_e2 = np.zeros((0, 3), np.float32)
            tri_shade = np.zeros((0, 13), np.float32)
            tri_tf_id = np.zeros(1, np.int32)
            tri_det_eps = np.zeros((0,), np.float32)

        # lights
        lp = self.point_lights
        la = self.area_lights
        plight_pos = np.array([l.position for l in lp], np.float32).reshape(-1, 3)
        plight_int = np.array([l.intensity for l in lp], np.float32).reshape(-1, 3)
        a_corner = np.array([l.corner for l in la], np.float32).reshape(-1, 3)
        a_ufull = np.array([l.uvec for l in la], np.float32).reshape(-1, 3)
        a_vfull = np.array([l.vvec for l in la], np.float32).reshape(-1, 3)
        a_int = np.array([l.intensity for l in la], np.float32).reshape(-1, 3)
        a_steps = tuple((int(l.usteps), int(l.vsteps)) for l in la)
        a_uvec = a_ufull / np.array([[l.usteps] for l in la] or [[1]], np.float32)
        a_vvec = a_vfull / np.array([[l.vsteps] for l in la] or [[1]], np.float32)
        a_pos = a_corner + (a_ufull + a_vfull) / 2.0

        # patterns
        np_ = max(len(self.patterns), 1)
        pat_kind = np.zeros(np_, np.int32)
        pat_a = np.zeros((np_, 3), np.float32)
        pat_b = np.zeros((np_, 3), np.float32)
        pat_inv = np.tile(np.eye(4, dtype=np.float32), (np_, 1, 1))
        pat_map = np.zeros(np_, np.int32)
        pat_uv = np.full((np_, 6), _DEF_UV, np.int32)
        for i, p in enumerate(self.patterns):
            pat_kind[i], pat_map[i] = p["kind"], p["mapping"]
            pat_a[i], pat_b[i] = p["a"], p["b"]
            pat_inv[i] = p["inv"]
            pat_uv[i] = p["uv"]

        nu = max(len(self.uvs), 1)
        uv_kind = np.zeros(nu, np.int32)
        uv_wh = np.ones((nu, 2), np.float32)
        uv_colors = np.zeros((nu, 5, 3), np.float32)
        uv_image = np.full(nu, -1, np.int32)
        for i, u in enumerate(self.uvs):
            uv_kind[i] = u["kind"]
            uv_wh[i] = (u["w"], u["h"])
            uv_colors[i] = u["colors"]
            uv_image[i] = u["image"]

        if self.images:
            hmax = max(im.shape[0] for im in self.images)
            wmax = max(im.shape[1] for im in self.images)
            images = np.zeros((len(self.images), hmax, wmax, 3), np.float32)
            image_wh = np.zeros((len(self.images), 2), np.int32)
            for i, im in enumerate(self.images):
                images[i, : im.shape[0], : im.shape[1]] = im
                image_wh[i] = (im.shape[1], im.shape[0])
        else:
            images = np.zeros((1, 1, 1, 3), np.float32)
            image_wh = np.ones((1, 2), np.int32)

        used = mat_table[src_mat_id] if g else mat_table[:0]
        has_reflective = bool((used[:, T.MAT_REFLECTIVE] != 0).any())
        has_transparency = bool((used[:, T.MAT_TRANSPARENCY] != 0).any())
        has_blend = bool(
            ((used[:, T.MAT_REFLECTIVE] != 0)
             & (used[:, T.MAT_TRANSPARENCY] != 0)).any()
        )
        # free (non-CSG) triangles with a transparent material need the
        # nearest-behind candidate column (intersect.candidate_hits)
        transp = mat_table[:, T.MAT_TRANSPARENCY] != 0
        mesh_transparent = bool(
            transp[mat_id[g_nt + n_csg_tris : g]].any()
        ) if nt - n_csg_tris > 0 else False
        # every object's RI is exactly 1.0 -> the n1/n2 walk is the
        # constant (1, 1) and shade_level skips it (types.all_ri_one)
        all_ri_one = bool(
            g and (used[:, T.MAT_REFRACTIVE] == 1.0).all()
        )

        static = T.SceneStatic(
            counts=counts,
            area_steps=a_steps,
            csg_nodes=tuple(self.csg_nodes),
            csg_members=tuple(csg_members),
            n_csg_tris=n_csg_tris,
            has_reflective=has_reflective,
            has_transparency=has_transparency,
            has_blend=has_blend,
            mesh_transparent=mesh_transparent,
            jitter=tuple(jitter) if jitter is not None else None,
            mesh_all_shadow=(
                bool(tb["src_shadow"].all()) if tb is not None else True
            ),
            mesh_uniform_refr=(
                float(tb["mat_src"][0, T.MAT_REFRACTIVE])
                if tb is not None and np.unique(
                    tb["mat_src"][:, T.MAT_REFRACTIVE]).size == 1
                else None
            ),
            all_ri_one=all_ri_one,
            recursion_limit=recursion_limit,
        )

        # Device arrays from the start: eager (non-jit) rendering traces
        # lax.scan bodies that can't index host numpy with tracers, and
        # keeping one device-resident copy avoids re-uploading the SoA on
        # every dispatch.
        import jax.numpy as jnp

        def dev(x):
            return jnp.asarray(x)

        # The free mesh's search tables, built once here: the GPU kernel's
        # SoA planes and the chunk AABBs that both the kernel and the scan
        # read (intersect.TRI_CHUNK triangles per box).
        mesh_planes = mesh_bb_chunk = None
        if nt > n_csg_tris:
            sl = slice(n_csg_tris, nt)
            mesh_planes, mesh_bb_chunk = pack_planes(
                tri_p1[sl], tri_e1[sl], tri_e2[sl], tri_det_eps[sl])

        return jax.tree.map(dev, T.Scene(
            mat=mat_table, mat_id=mat_id,
            pattern_id=pattern_id, shadow=shadow, inv_tf=inv_tf,
            normal_mat=normal_mat,
            cyl_min=cyl_min, cyl_max=cyl_max, cyl_closed=cyl_closed,
            cone_min=cone_min, cone_max=cone_max, cone_closed=cone_closed,
            tri_p1=tri_p1, tri_e1=tri_e1, tri_e2=tri_e2,
            tri_shade=tri_shade,
            tri_tf_id=tri_tf_id,
            tri_det_eps=tri_det_eps,
            plight_pos=plight_pos, plight_intensity=plight_int,
            alight_corner=a_corner, alight_uvec=a_uvec, alight_vvec=a_vvec,
            alight_pos=a_pos, alight_intensity=a_int,
            pat_kind=pat_kind, pat_a=pat_a, pat_b=pat_b, pat_inv=pat_inv,
            pat_map=pat_map, pat_uv=pat_uv,
            uv_kind=uv_kind, uv_wh=uv_wh, uv_colors=uv_colors,
            uv_image=uv_image, images=images, image_wh=image_wh,
            mesh_planes=mesh_planes, mesh_bb_chunk=mesh_bb_chunk,
            static=static,
        ))

"""Device-side scene representation: SoA arrays, one table per concept.

This replaces the reference's enum-of-structs + global slotmap registries
(/root/reference/src/shapes.rs:28-36, groups.rs:16-30, uv_pattern.rs:109-111)
with flat, padded arrays — pure data, no registries, trivially shardable and
differentiable.

Design notes:

* Every primitive gets a global id ``gid``; per-gid tables hold material,
  pattern id, shadow flag and the composed world->object inverse transform.
  Group hierarchies are flattened at compile time by composing the affine
  chain (exact: the 3x3 normal blocks compose for affine maps, and the
  reference's per-level normalize() only rescales by positive factors, so
  one final normalize is equivalent — see shapes.rs:272-292 semantics).

* Triangles are stored in WORLD space (vertices pre-transformed on the
  host). Moller-Trumbore on world-space vertices yields identical t/u/v
  because the reference's ray.transform never renormalizes the direction
  (rays.rs:19-24), so t is preserved across spaces. This removes all
  per-ray matrix work from the mesh hot loop.

* Smooth-triangle shading normals n1/n2/n3 are pre-multiplied by the
  normal matrix (unnormalized); barycentric interpolation then one final
  normalize equals the reference's interpolate-then-transform-then-
  normalize (linearity).

* CSG trees are encoded as per-prim bitmasks over (at most 32) CSG nodes:
  bit n of ``csg_under`` = prim lives in node n's subtree, bit n of
  ``csg_left`` = prim lives in node n's LEFT subtree. The filter rules
  (csg.rs:117-123) then become masked parity prefix-sums over the per-root
  t-sorted candidate list — no recursion, no stacks.

* Static/topological facts (family counts, CSG node order, area-light step
  counts, feature flags) live in :class:`SceneStatic`, a hashable aux
  object, so a :class:`Scene` works as a jit argument and a grad target.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np

# Family order for gid assignment. Offsets are cumulative counts.
FAMILIES = ("sphere", "plane", "cube", "cylinder", "cone", "triangle")

# Pattern kinds (patterns.rs enum)
PAT_STRIPED, PAT_GRADIENT, PAT_RING, PAT_CHECKER, PAT_XYZRGB, PAT_TEXTURE, PAT_CUBEMAP = range(7)
# UV mapping kinds (texture_map.rs UvMapping)
MAP_SPHERICAL, MAP_PLANAR, MAP_CYLINDRICAL = range(3)
# UV pattern kinds (uv_pattern.rs enum)
UV_CHECKER, UV_ALIGN, UV_IMAGE = range(3)
# CSG ops (csg.rs CsgOp)
CSG_UNION, CSG_INTERSECT, CSG_DIFFERENCE = range(3)

# Material table columns
MAT_COLOR = slice(0, 3)
MAT_AMBIENT, MAT_DIFFUSE, MAT_SPECULAR, MAT_SHININESS = 3, 4, 5, 6
MAT_REFLECTIVE, MAT_TRANSPARENCY, MAT_REFRACTIVE = 7, 8, 9
MAT_NCOLS = 10


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    """Hashable static scene facts (jit-static; pytree aux data)."""

    counts: tuple  # (n_sphere, n_plane, n_cube, n_cylinder, n_cone, n_triangle)
    # ((usteps, vsteps), ...) one per area light; point lights need none.
    area_steps: tuple = ()
    # CSG nodes in bottom-up (children-before-parents) order:
    # (op_code, bit_index, root_bit_index) per node. root_bit_index marks
    # which root tree the node belongs to (used to group candidates).
    csg_nodes: tuple = ()
    # ((gid, under_mask, left_mask), ...) for every primitive inside a CSG
    # tree. Static: the filter needs membership to pick candidate columns.
    csg_members: tuple = ()
    # Leading count of triangles that live inside CSG trees (builder orders
    # them first within the triangle family; they take dense candidate
    # columns so the CSG filter sees every hit).
    n_csg_tris: int = 0
    has_reflective: bool = False
    has_transparency: bool = False
    # Some material has BOTH reflective > 0 and transparency > 0 (the
    # Schlick-blended case, world.rs:78-87). When False, every hit spawns
    # at most one live child (reflection XOR refraction), so the wavefront
    # integrator merges both spawn streams into one and the level width
    # stays constant at R instead of doubling (2^L R) — exact
    # (render.color_at).
    has_blend: bool = False
    # Any FREE (non-CSG) mesh triangle with transparency > 0: the n1/n2
    # container walk then also needs the nearest-BEHIND triangle entry
    # (see intersect.candidate_hits).
    mesh_transparent: bool = False
    # Deterministic area-light jitter sequence (test mode, lights.rs:77-81);
    # None means seeded-random jitter.
    jitter: tuple | None = None
    # Every triangle SOURCE casts shadows: the mesh shadow query then
    # skips its per-hit flag lookup entirely (a gather from a
    # per-triangle table; scenes using the shadow:false opt-out on meshes
    # are rare).
    mesh_all_shadow: bool = True
    # All triangle sources share one refractive index -> that value, else
    # None. Lets the n1/n2 walk's dynamic mesh columns skip their per-ray
    # material lookup (the common case: one glass material per mesh).
    mesh_uniform_refr: float | None = None
    # EVERY material in the scene has refractive_index == 1.0: the n1/n2
    # container walk can only ever return (1.0, 1.0) — whatever objects a
    # ray is inside, their RI is 1 — so shade_level skips the full
    # candidate table + walk and feeds the (bit-identical) constants to
    # the refraction math. Transparency still spawns pass-through rays
    # (dragons.yaml's bounding boxes are exactly this: transparent RI=1
    # shells around opaque meshes).
    all_ri_one: bool = False
    recursion_limit: int = 4

    @property
    def offsets(self) -> tuple:
        off, acc = [], 0
        for c in self.counts:
            off.append(acc)
            acc += c
        return tuple(off)

    @property
    def n_prims(self) -> int:
        return sum(self.counts)

    def family_range(self, name: str) -> tuple:
        i = FAMILIES.index(name)
        return self.offsets[i], self.counts[i]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Scene:
    """All scene data as arrays. Array fields are pytree leaves (grad-able);
    ``static`` is aux metadata."""

    # --- per-primitive attribute tables (COMPACT indexing) ---------------
    # Materials are deduplicated: ``mat`` holds the M unique rows and
    # ``mat_id`` maps a compact row -> unique material. mat_id/pattern_id/
    # shadow are indexed like inv_tf: non-triangle gids first, then ONE row
    # per triangle SOURCE (gid -> row via intersect.transform_row). Every
    # triangle of a mesh shares its source's attributes, so per-gid
    # [G~1M] tables would buy nothing except turning each attribute
    # lookup into a million-row gather; compactly the only big gather
    # left is the shared tri_tf_id row map.
    mat: Any            # f32 [M, MAT_NCOLS] unique material rows
    mat_id: Any         # i32 [Gn + n_tf] material row per compact row
    pattern_id: Any     # i32 [Gn + n_tf]   (-1 = none)
    shadow: Any         # bool [Gn + n_tf]  casts shadows (world.rs:107)
    # Transform tables cover the NON-TRIANGLE gids followed by one row per
    # triangle SOURCE (an individually-added triangle, or a whole mesh
    # block — every triangle of a mesh shares its block's transform).
    # A row per triangle would make these tables ~100 MB on a
    # 1M-triangle scene and turn the per-hit row gather into a
    # million-row gather; the compact table gathers cheaply. Triangle gid
    # -> row via ``Gn + tri_tf_id[gid - Gn]`` (intersect.transform_row).
    # Triangle INTERSECTION never reads these (vertices are
    # world-space-pretransformed); only pattern-space mapping does.
    inv_tf: Any         # f32 [Gn + n_tf, 4, 4] world -> object
    normal_mat: Any     # f32 [Gn + n_tf, 3, 3] local normals -> world
    # --- per-family params ----------------------------------------------
    cyl_min: Any        # f32 [Ncy]
    cyl_max: Any        # f32 [Ncy]
    cyl_closed: Any     # bool [Ncy]
    cone_min: Any       # f32 [Nco]
    cone_max: Any       # f32 [Nco]
    cone_closed: Any    # bool [Nco]
    tri_p1: Any         # f32 [Nt, 3] world space
    tri_e1: Any         # f32 [Nt, 3]
    tri_e2: Any         # f32 [Nt, 3]
    # One row per triangle with everything the shading pass needs:
    # [n1(3) | n2(3) | n3(3) | flat_n(3) | smooth flag]. Packed so a hit
    # costs ONE per-triangle gather instead of five separate [Nt] ones
    # (gather cost is per row visited, not per byte).
    tri_shade: Any      # f32 [Nt, 13] world-space normals + smooth flag
    tri_tf_id: Any      # i32 [max(Nt,1)] transform row (see inv_tf) per tri
    # Per-triangle Moller-Trumbore det threshold: EPSILON * |det(A)| of
    # the triangle's instance transform. The reference tests
    # |det| < EPSILON in OBJECT space (triangle.rs:96), where det_obj =
    # det_world / det(A) — a fixed world-space epsilon silently erased
    # ENTIRE scaled-down mesh instances (dragons-scale triangles have
    # |e1 x e2| ~ 1e-5 in world space, so every det fell below 1e-4; the
    # r2-r4 dragons frames contained no mesh pixels at all).
    tri_det_eps: Any    # f32 [Nt]
    # --- lights -----------------------------------------------------------
    plight_pos: Any     # f32 [Lp, 3]
    plight_intensity: Any  # f32 [Lp, 3]
    alight_corner: Any  # f32 [La, 3]
    alight_uvec: Any    # f32 [La, 3]  (full_uvec / usteps, lights.rs:95)
    alight_vvec: Any    # f32 [La, 3]
    alight_pos: Any     # f32 [La, 3]  corner + (full_u + full_v)/2
    alight_intensity: Any  # f32 [La, 3]
    # --- patterns -----------------------------------------------------------
    pat_kind: Any       # i32 [P]
    pat_a: Any          # f32 [P, 3]
    pat_b: Any          # f32 [P, 3]
    pat_inv: Any        # f32 [P, 4, 4]
    pat_map: Any        # i32 [P] uv mapping kind
    pat_uv: Any         # i32 [P, 6] uv-pattern ids (texmap: slot 0;
    #                     cubemap: left,right,front,back,up,down)
    uv_kind: Any        # i32 [U]
    uv_wh: Any          # f32 [U, 2]
    uv_colors: Any      # f32 [U, 5, 3] checker: rows 0,1; align: main,ul,ur,bl,br
    uv_image: Any       # i32 [U]
    images: Any         # f32 [I, Hmax, Wmax, 3]
    image_wh: Any       # i32 [I, 2]  (width, height) of each image
    # --- free-mesh search tables (derived; built once by builder.finish) --
    # The GPU kernel's structure-of-arrays copy of the free triangles
    # (ops/mesh_kernel.pack_planes) and the AABB of every TRI_CHUNK-triangle
    # chunk, which the kernel and the scan both read. As pytree leaves they
    # stay on device and no query rebuilds them. None without a free mesh.
    mesh_planes: Any = None    # f32 [10, N_pad] p1, e1, e2 xyz + det_eps
    mesh_bb_chunk: Any = None  # f32 [6, N_pad / TRI_CHUNK] min xyz, max xyz
    # --- static -----------------------------------------------------------
    static: SceneStatic = dataclasses.field(
        metadata=dict(static=True), default=None
    )

    def family_slice(self, name: str, table):
        off, n = self.static.family_range(name)
        return table[off : off + n]


def _pad_rows(arr: np.ndarray, min_rows: int = 1) -> np.ndarray:
    if arr.shape[0] >= min_rows:
        return arr
    pad = [(0, min_rows - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)

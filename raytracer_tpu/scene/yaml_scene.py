"""YAML scene description → (Camera, Scene), byte-compatible with the
reference's format.

Reproduces the reference's scene.rs semantics (the YAML subset it uses is
read by scene/yaml_lite.py):

* instruction list of ``add`` (camera / point-light / area-light / shapes /
  group / csg) and ``define`` entries (scene.rs:229-272,304-382,910-919);
* ``define``/``extend``: a transform define = concatenation of the extended
  defines' op-lists then its own ops; a material define = list of partial
  material specs applied in order (scene.rs:152-182);
* on shapes, ``extend`` applies each named define's transform ops and
  material specs first, then the shape's own (scene.rs:629-661);
* transform specs are op-lists ``[op, args...]`` applied in order through
  the left-multiplying builder (scene.rs:952-1143);
* math expressions ("PI/3") in field-of-view and rotation angles
  (scene.rs:274-290);
* group: optional OBJ file bound by *file name* from the CLI's --obj list,
  nested shapes/groups, material applied to the OBJ's triangles
  (scene.rs:570-627); ``divide`` is accepted (BVH hint — acceleration here
  is handled by the mesh-culling renderer instead);
* csg: op + two args, nested (scene.rs:663-786);
* texture images: PPM files bound by file name from --ppm (scene.rs:96-106).

Validation matches scene.rs:51-64: at least one camera and one light.
"""

from __future__ import annotations

import ast
import math
import operator
from pathlib import Path

import numpy as np

from raytracer_tpu import transforms as tf
from raytracer_tpu.camera import Camera
from raytracer_tpu.canvas import from_ppm_bytes
from raytracer_tpu.obj import parse_obj
from raytracer_tpu.scene import specs as S
from raytracer_tpu.scene.builder import build_scene
from raytracer_tpu.scene.yaml_lite import safe_load

_MATH_NAMES = {
    "PI": math.pi, "pi": math.pi,
    "TAU": math.tau, "tau": math.tau,
    "E": math.e, "e": math.e,
}
_BIN_OPS = {
    ast.Add: operator.add, ast.Sub: operator.sub,
    ast.Mult: operator.mul, ast.Div: operator.truediv,
    ast.Pow: operator.pow, ast.Mod: operator.mod,
}


def eval_math(expr) -> float:
    """Safe arithmetic evaluator for YAML scalar expressions like "PI/3"
    (the reference uses the meval crate, scene.rs:274-290)."""
    if isinstance(expr, (int, float)):
        return float(expr)

    def ev(node):
        if isinstance(node, ast.Expression):
            return ev(node.body)
        if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
            return float(node.value)
        if isinstance(node, ast.Name):
            if node.id in _MATH_NAMES:
                return _MATH_NAMES[node.id]
            raise ValueError(f"Unknown constant: {node.id}")
        if isinstance(node, ast.BinOp) and type(node.op) in _BIN_OPS:
            return _BIN_OPS[type(node.op)](ev(node.left), ev(node.right))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.USub):
                return -ev(node.operand)
            if isinstance(node.op, ast.UAdd):
                return ev(node.operand)
        raise ValueError(f"Invalid math expression: {expr!r}")

    return ev(ast.parse(str(expr), mode="eval"))


# --- transform / material specs --------------------------------------------


def _transform_ops(entries) -> list:
    """Parse a YAML transform op-list into [(op, args...), ...]."""
    ops = []
    for entry in entries or []:
        op, *args = entry
        if op in ("rotate-x", "rotate-y", "rotate-z"):
            ops.append((op, eval_math(args[0])))
        elif op in ("translate", "scale"):
            ops.append((op, *(eval_math(a) for a in args[:3])))
        elif op == "shear":
            ops.append((op, *(eval_math(a) for a in args[:6])))
        else:
            raise ValueError(f"Unknown transform op: {op}")
    return ops


def _apply_ops(t: tf.Transform, ops) -> tf.Transform:
    for op, *args in ops:
        t = {
            "translate": t.translation, "scale": t.scaling,
            "rotate-x": t.rotation_x, "rotate-y": t.rotation_y,
            "rotate-z": t.rotation_z, "shear": t.shearing,
        }[op](*args)
    return t


_MAT_KEYS = (
    "color", "ambient", "diffuse", "specular", "shininess",
    "reflective", "transparency", "refractive-index", "pattern",
)


def _apply_material_spec(mat: S.Material, spec: dict, ctx) -> S.Material:
    """MaterialSpec::update (scene.rs:1159-1190): partial override."""
    kw = {}
    if "pattern" in spec:
        kw["pattern"] = ctx.make_pattern(spec["pattern"])
    if "color" in spec:
        kw["color"] = tuple(float(c) for c in spec["color"])
    for key, field in (
        ("ambient", "ambient"), ("diffuse", "diffuse"),
        ("specular", "specular"), ("shininess", "shininess"),
        ("reflective", "reflective"), ("transparency", "transparency"),
        ("refractive-index", "refractive_index"),
    ):
        if key in spec:
            kw[field] = float(spec[key])
    return mat.replace(**kw)


class SceneContext:
    """Holds defines and file bindings while interpreting instructions."""

    def __init__(self, obj_files=(), ppm_files=()):
        self.define_transforms: dict[str, list] = {}
        self.define_materials: dict[str, list] = {}
        self.obj_by_name = {Path(p).name: Path(p) for p in obj_files}
        self.ppm_by_name = {Path(p).name: Path(p) for p in ppm_files}
        self._image_cache: dict[str, np.ndarray] = {}

    # -- defines (scene.rs:152-182) -------------------------------------

    def add_define(self, instr: dict):
        name = instr["define"]
        extend = instr.get("extend") or []
        if "transform" in instr and instr["transform"]:
            specs = []
            for definition in extend:
                specs.extend(self.define_transforms.get(definition, []))
            specs.extend(_transform_ops(instr["transform"]))
            self.define_transforms[name] = specs
        if "material" in instr and instr["material"] is not None:
            specs = []
            for definition in extend:
                specs.extend(self.define_materials.get(definition, []))
            specs.append(instr["material"])
            self.define_materials[name] = specs

    # -- merge (scene.rs:629-661) ----------------------------------------

    def transform_material(self, instr: dict):
        t = tf.Transform()
        mat = S.Material()
        for definition in instr.get("extend") or []:
            t = _apply_ops(t, self.define_transforms.get(definition, []))
            for spec in self.define_materials.get(definition, []):
                mat = _apply_material_spec(mat, spec, self)
        t = _apply_ops(t, _transform_ops(instr.get("transform")))
        if instr.get("material") is not None:
            mat = _apply_material_spec(mat, instr["material"], self)
        return t.matrix, mat

    # -- patterns (scene.rs:1192-1348) -----------------------------------

    def make_pattern(self, spec: dict) -> S.Pattern:
        kind = spec["kind"]
        transform = None
        if spec.get("transform"):
            transform = _apply_ops(tf.Transform(), _transform_ops(spec["transform"])).matrix
        if kind in ("stripes", "striped", "gradient", "ring", "checker"):
            yaml_kind = {"stripes": "striped"}.get(kind, kind)
            a, b = spec["colors"]
            return S.Pattern(yaml_kind, a=tuple(a), b=tuple(b), transform=transform)
        if kind == "xyz-rgb":
            return S.Pattern("xyz_rgb", transform=transform)
        if kind == "texture-map":
            return S.Pattern(
                "texture_map",
                transform=transform,
                mapping=spec["uv-mapping"],
                uv_pattern=self.make_uv_pattern(spec["uv-pattern"]),
            )
        if kind == "cube-map":
            return S.Pattern(
                "cube_map",
                transform=transform,
                **{
                    face: self.make_uv_pattern(spec[face])
                    for face in ("left", "right", "front", "back", "up", "down")
                },
            )
        raise ValueError(f"Unknown pattern kind: {kind}")

    def make_uv_pattern(self, spec: dict) -> S.UvPatternSpec:
        kind = spec["kind"]
        if kind == "checker":
            a, b = spec["colors"]
            return S.UvPatternSpec(
                "checker", width=float(spec["width"]), height=float(spec["height"]),
                a=tuple(a), b=tuple(b),
            )
        if kind == "align-check":
            return S.UvPatternSpec(
                "align_check",
                main=tuple(spec["main"]), ul=tuple(spec["ul"]), ur=tuple(spec["ur"]),
                bl=tuple(spec["bl"]), br=tuple(spec["br"]),
            )
        if kind == "image":
            name = spec["ppm"]
            if name not in self._image_cache:
                path = self.ppm_by_name.get(name)
                if path is None:
                    raise FileNotFoundError(f"Couldn't find ppm file named: {name}")
                self._image_cache[name] = from_ppm_bytes(path.read_bytes())
            return S.UvPatternSpec("image", image=self._image_cache[name])
        raise ValueError(f"Unknown uv-pattern kind: {kind}")

    # -- shapes ----------------------------------------------------------

    def make_shape(self, instr: dict, kind: str):
        m, mat = self.transform_material(instr)
        shadow = bool(instr.get("shadow", True))
        common = dict(transform=m, material=mat, shadow=shadow)
        if kind == "sphere":
            return S.Sphere(**common)
        if kind == "plane":
            return S.Plane(**common)
        if kind == "cube":
            return S.Cube(**common)
        if kind in ("cylinder", "cone"):
            cls = S.Cylinder if kind == "cylinder" else S.Cone
            return cls(
                **common,
                min=float(instr["min"]) if "min" in instr else -np.inf,
                max=float(instr["max"]) if "max" in instr else np.inf,
                closed=bool(instr.get("closed", False)),
            )
        if kind == "triangle":
            return S.Triangle(
                **common,
                p1=tuple(instr["p1"]), p2=tuple(instr["p2"]), p3=tuple(instr["p3"]),
            )
        if kind == "smooth-triangle":
            return S.SmoothTriangle(
                **common,
                p1=tuple(instr["p1"]), p2=tuple(instr["p2"]), p3=tuple(instr["p3"]),
                n1=tuple(instr["n1"]), n2=tuple(instr["n2"]), n3=tuple(instr["n3"]),
            )
        raise ValueError(f"Unknown shape: {kind}")

    def make_group(self, instr: dict) -> S.Group:
        """scene.rs:570-627: OBJ-or-empty group, group material feeds the
        OBJ triangles only, nested shapes/groups appended."""
        m, mat = self.transform_material(instr)
        if instr.get("obj"):
            name = instr["obj"]
            path = self.obj_by_name.get(name)
            if path is None:
                raise FileNotFoundError(f"Couldn't find file named {name}")
            group = parse_obj(path.read_text(), mat)
        else:
            group = S.Group()
        group.transform = m
        for child in instr.get("shapes") or []:
            kind = child["add"]
            if kind == "group":
                group.children.append(self.make_group(child))
            else:
                group.children.append(self.make_shape(child, kind))
        return group

    def make_csg(self, instr: dict) -> S.Csg:
        left, right = instr["args"]
        return S.Csg(
            op={"union": "union", "intersect": "intersect",
                "difference": "difference"}[instr["op"]],
            left=self._csg_child(left),
            right=self._csg_child(right),
        )

    def _csg_child(self, spec: dict):
        if spec["kind"] == "csg":
            left, right = spec["args"]
            return S.Csg(
                op=spec["op"], left=self._csg_child(left), right=self._csg_child(right)
            )
        return self.make_shape(spec, spec["kind"])


def parse_scene(
    text: str,
    *,
    obj_files=(),
    ppm_files=(),
    jitter=None,
    recursion_limit: int = 4,
):
    """YAML text → (Camera, device Scene). ``jitter`` enables the
    deterministic area-light sequence (the reference's test hook injects
    [0.5], scene.rs:145-147)."""
    instructions = safe_load(text)
    if not isinstance(instructions, list):
        raise ValueError("Scene YAML must be a list of instructions")

    ctx = SceneContext(obj_files, ppm_files)
    camera = None
    items: list = []

    for instr in instructions:
        if "define" in instr:
            ctx.add_define(instr)
            continue
        kind = instr["add"]
        if kind == "camera":
            camera = Camera(
                int(instr["width"]), int(instr["height"]),
                eval_math(instr["field-of-view"]),
            ).with_transform(
                tf.view_transform(instr["from"], instr["to"], instr["up"])
            )
        elif kind == "point-light":
            items.append(S.PointLight(
                position=tuple(instr["at"]), intensity=tuple(instr["intensity"])
            ))
        elif kind == "area-light":
            items.append(S.AreaLight(
                corner=tuple(instr["corner"]),
                uvec=tuple(instr["uvec"]), usteps=int(instr["usteps"]),
                vvec=tuple(instr["vvec"]), vsteps=int(instr["vsteps"]),
                intensity=tuple(instr["intensity"]),
            ))
        elif kind == "group":
            items.append(ctx.make_group(instr))
        elif kind == "csg":
            items.append(ctx.make_csg(instr))
        else:
            items.append(ctx.make_shape(instr, kind))

    if camera is None:
        raise ValueError("A camera is required")
    if not any(isinstance(i, (S.PointLight, S.AreaLight)) for i in items):
        raise ValueError("At least one light is required")

    scene = build_scene(items, jitter=jitter, recursion_limit=recursion_limit)
    return camera, scene


def render_scene_file(
    scene_path,
    *,
    obj_files=(),
    ppm_files=(),
    dithering=None,
    tile_rays=None,
    key=None,
):
    """Scene::render (scene.rs:72-227): YAML file → Canvas (after optional
    dithering). Callers write PPM via Canvas.to_ppm."""
    from raytracer_tpu.canvas import Canvas
    from raytracer_tpu.core.render import render

    text = Path(scene_path).read_text()
    camera, scene = parse_scene(text, obj_files=obj_files, ppm_files=ppm_files)
    # No dithering -> the image goes straight to u8 PPM, so quantize on
    # device (4x smaller transfer; u8/255 -> quantize_u8 round-trips
    # exactly, verified in test_canvas_camera). Dithering operates on the
    # float canvas (scene.rs:215-222), so it keeps the float path.
    q = dithering is None
    img = render(scene, camera, tile_rays=tile_rays, key=key, quantize=q)
    if q:
        img = img.astype(np.float32) / 255.0
    canvas = Canvas(camera.hsize, camera.vsize, img)
    if dithering is not None:
        n, colored = {
            "bayer2": (2, False), "bayer4": (4, False), "bayer8": (8, False),
            "bayer16": (16, False), "bayer-color": (4, True),
        }[dithering]
        canvas.apply_dithering(n, colored)
    return canvas

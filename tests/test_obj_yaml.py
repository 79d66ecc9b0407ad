"""OBJ parser and YAML scene-interpreter oracles (reference src/obj.rs
tests and src/scene.rs semantics)."""

import math
from pathlib import Path

import numpy as np

from raytracer_tpu import transforms as tf
from raytracer_tpu.obj import parse_obj
from raytracer_tpu.scene import specs as S
from raytracer_tpu.scene.yaml_scene import eval_math, parse_scene, SceneContext


def all_meshes(group):
    out = []
    for child in group.children:
        if isinstance(child, S.Group):
            out.extend(all_meshes(child))
        else:
            out.append(child)
    return out


def test_obj_triangles():
    # obj.rs:49-80
    content = """
v -1 1 0
v -1 0 0
v 1 0 0
v 1 1 0

f 1 2 3
f 1 3 4
"""
    mesh = all_meshes(parse_obj(content))[0]
    assert mesh.p.shape == (2, 3, 3)
    assert np.allclose(mesh.p[0], [(-1, 1, 0), (-1, 0, 0), (1, 0, 0)])
    assert np.allclose(mesh.p[1], [(-1, 1, 0), (1, 0, 0), (1, 1, 0)])
    assert not mesh.smooth.any()


def test_obj_polygon_fan():
    # obj.rs pentagon fan-triangulation
    content = """
v -1 1 0
v -1 0 0
v 1 0 0
v 1 1 0
v 0 2 0

f 1 2 3 4 5
"""
    mesh = all_meshes(parse_obj(content))[0]
    assert mesh.p.shape == (3, 3, 3)
    assert np.allclose(mesh.p[2], [(-1, 1, 0), (1, 1, 0), (0, 2, 0)])


def test_obj_named_groups_and_normals():
    content = """
v 0 1 0
v -1 0 0
v 1 0 0

vn -1 0 0
vn 1 0 0
vn 0 1 0

g FirstGroup
f 1 2 3
g SecondGroup
f 1//3 2//1 3//2
"""
    g = parse_obj(content)
    meshes = all_meshes(g)
    assert len(meshes) == 2
    first, second = meshes
    assert not first.smooth.any()
    assert second.smooth.all()
    assert np.allclose(second.n[0], [(0, 1, 0), (-1, 0, 0), (1, 0, 0)])


def test_obj_python_fallback_matches_native():
    from raytracer_tpu import native
    from raytracer_tpu.obj import _parse_obj_python
    content = """
v 0 1 0
v -1 0 0
v 1 0 0
v 2 2 0
vn 0 0 1
g A
f 1 2 3
f 1 3 4
g B
f 1//1 2//1 3//1
"""
    py = _parse_obj_python(content)
    if not native.available():
        import pytest
        pytest.skip("native library unavailable")
    nat = native.parse_obj_arrays(content)
    for a, b in zip(py, nat):
        assert np.allclose(a, b), (a, b)


def test_obj_huge_polygon_face():
    # A 70-corner face must fan-triangulate to 68 triangles with every
    # output row written (the native path once capped corner buffers at 64,
    # leaving the trailing rows as uninitialized garbage).
    from raytracer_tpu import native
    from raytracer_tpu.obj import _parse_obj_python

    n = 70
    lines = [
        f"v {math.cos(2 * math.pi * i / n)} {math.sin(2 * math.pi * i / n)} 0"
        for i in range(n)
    ]
    lines.append("f " + " ".join(str(i + 1) for i in range(n)))
    content = "\n".join(lines) + "\n"

    py = _parse_obj_python(content)
    assert py[2].shape == (n - 2, 3)
    assert py[2].max() == n - 1 and py[2].min() == 0
    if native.available():
        nat = native.parse_obj_arrays(content)
        for a, b in zip(py, nat):
            assert np.allclose(a, b), (a, b)


def test_eval_math():
    assert abs(eval_math("PI/3") - math.pi / 3) < 1e-9
    assert abs(eval_math("-PI/2") + math.pi / 2) < 1e-9
    assert abs(eval_math(0.785) - 0.785) < 1e-12
    assert abs(eval_math("2*PI") - math.tau) < 1e-9


def test_define_extend_transform_merge():
    # cover.yaml semantics: large-object = standard-transform ops + scale
    ctx = SceneContext()
    ctx.add_define({
        "define": "standard-transform",
        "transform": [["translate", 1, -1, 1], ["scale", 0.5, 0.5, 0.5]],
    })
    ctx.add_define({
        "define": "large-object",
        "extend": ["standard-transform"],
        "transform": [["scale", 3.5, 3.5, 3.5]],
    })
    m, _ = ctx.transform_material({"extend": ["large-object"]})
    expected = (
        tf.Transform().translation(1, -1, 1).scaling(0.5, 0.5, 0.5)
        .scaling(3.5, 3.5, 3.5).matrix
    )
    assert np.allclose(m, expected, atol=1e-6)


def test_define_extend_material_merge():
    ctx = SceneContext()
    ctx.add_define({
        "define": "white-material",
        "material": {"color": [1, 1, 1], "diffuse": 0.7, "ambient": 0.1,
                     "specular": 0.0, "reflective": 0.1},
    })
    ctx.add_define({
        "define": "blue-material",
        "extend": ["white-material"],
        "material": {"color": [0.537, 0.831, 0.914]},
    })
    _, mat = ctx.transform_material({"extend": ["blue-material"]})
    assert np.allclose(mat.color, (0.537, 0.831, 0.914))
    assert mat.diffuse == 0.7 and mat.specular == 0.0 and mat.reflective == 0.1
    # shape's own material overrides the extend
    _, mat = ctx.transform_material({
        "extend": ["blue-material"], "material": {"diffuse": 0.2},
    })
    assert mat.diffuse == 0.2
    assert np.allclose(mat.color, (0.537, 0.831, 0.914))


def test_transform_op_order():
    # scene op lists apply in order: scale THEN translate
    ctx = SceneContext()
    m, _ = ctx.transform_material({
        "transform": [["scale", 0.5, 0.5, 0.5], ["translate", 1.5, 0.5, -0.5]],
    })
    expected = tf.Transform().scaling(0.5, 0.5, 0.5).translation(1.5, 0.5, -0.5).matrix
    assert np.allclose(m, expected)
    # a point at origin maps to the translation offset
    assert np.allclose((m @ [0, 0, 0, 1])[:3], [1.5, 0.5, -0.5])


def test_scene_validation():
    import pytest
    with pytest.raises(ValueError, match="camera"):
        parse_scene("- add: point-light\n  at: [0,0,0]\n  intensity: [1,1,1]\n")
    with pytest.raises(ValueError, match="light"):
        parse_scene(
            "- add: camera\n  width: 10\n  height: 10\n"
            "  field-of-view: 1.0\n  from: [0,0,-5]\n  to: [0,0,0]\n  up: [0,1,0]\n"
        )


def test_full_scene_parse():
    text = """
- add: camera
  width: 32
  height: 20
  field-of-view: PI/3
  from: [0, 1.5, -5]
  to: [0, 1, 0]
  up: [0, 1, 0]
- add: point-light
  at: [-10, 10, -10]
  intensity: [1, 1, 1]
- define: shiny
  material:
    reflective: 0.9
    specular: 0.9
- add: sphere
  extend: [shiny]
  transform:
    - [translate, 0, 1, 0]
- add: cylinder
  min: 0
  max: 2
  closed: true
- add: csg
  op: union
  args:
  - kind: sphere
  - kind: cube
    transform:
    - [rotate-y, PI/4]
"""
    cam, scene = parse_scene(text)
    assert cam.hsize == 32 and cam.vsize == 20
    assert abs(cam.field_of_view - math.pi / 3) < 1e-6
    # counts: spheres (1 standalone + 1 csg), cube (csg), cylinder
    assert scene.static.counts[0] == 2
    assert scene.static.counts[2] == 1
    assert scene.static.counts[3] == 1
    assert len(scene.static.csg_nodes) == 1
    assert scene.static.has_reflective


def test_astronaut_scene_renders():
    """samples/scenes/astronaut.yaml end-to-end: the one reference scene
    whose OBJ asset ships with the repo but has no committed golden —
    smoke the full YAML->OBJ->render path on one 8-row band."""
    from pathlib import Path
    import numpy as np
    import jax.numpy as jnp
    from raytracer_tpu.camera import ray_grid
    from raytracer_tpu.core.render import color_at

    scenes = Path("/root/reference/samples/scenes")
    objs = Path("/root/reference/samples/obj")
    if not (scenes / "astronaut.yaml").exists():
        import pytest
        pytest.skip("reference assets missing")
    cam, scene = parse_scene(
        (scenes / "astronaut.yaml").read_text(),
        obj_files=[str(objs / "astronaut.obj")],
    )
    assert scene.static.counts[5] > 6000  # fan-triangulated astronaut
    origins, directions = ray_grid(cam)
    w = cam.hsize
    rows = slice(250 * w, 258 * w)
    img = np.asarray(color_at(scene, origins[rows], directions[rows]))
    assert np.isfinite(img).all()
    assert img.max() > 0.05  # the model is lit, not a black frame


def test_obj_group_scale_det_eps(tmp_path):
    """A scaled OBJ group instance gets the object-space epsilon
    (EPSILON * |det A|, types.Scene.tri_det_eps) through the full
    YAML -> OBJ -> scene path, so heavily scaled-down meshes still
    render (r5 regression: they were entirely invisible). The mesh is
    the seeded teapot stand-in (benchmarks/gen_mesh.py), cut down."""
    import sys
    import numpy as np
    from raytracer_tpu.constants import EPSILON

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from benchmarks.gen_mesh import obj_text

    obj_p = tmp_path / "teapot_low.obj"
    obj_p.write_text(obj_text(seed=3, n_lon=16, n_lat=9))

    s = 0.01
    yaml_src = f"""
- add: camera
  width: 8
  height: 8
  field-of-view: 1.0
  from: [0, 0, -3]
  to: [0, 0, 0]
  up: [0, 1, 0]
- add: point-light
  at: [-10, 10, -10]
  intensity: [1, 1, 1]
- add: group
  obj: teapot_low.obj
  transform:
  - [scale, {s}, {s}, {s}]
"""
    cam, scene = parse_scene(
        yaml_src,
        obj_files=[str(obj_p)],
    )
    nt = int(scene.static.counts[5])
    assert nt > 100
    deps = np.asarray(scene.tri_det_eps)
    np.testing.assert_allclose(deps, EPSILON * s**3, rtol=1e-4)

    # and the scaled-down mesh is actually hit by an aimed ray
    import jax.numpy as jnp
    from raytracer_tpu.core import intersect as I

    p1 = np.asarray(scene.tri_p1[0])
    e1 = np.asarray(scene.tri_e1[0])
    e2 = np.asarray(scene.tri_e2[0])
    c = p1 + e1 / 3 + e2 / 3
    o0 = np.array([0.0, 0.0, -3.0], np.float32)
    d0 = c - o0
    d0 = d0 / np.linalg.norm(d0)
    has, t, g, u, v = I.nearest_hit(
        scene, jnp.asarray(o0[None]), jnp.asarray(d0[None]))
    assert bool(has[0])

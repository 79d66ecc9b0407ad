"""The benchmark's mesh scenes, built from the seeded teapot stand-in.

    dragons(obj)      benchmarks/dragons_equiv.yaml: 168 instances, 1,061,760
                      smooth triangles, 1200x480, depth 4
    glass_mesh(obj)   56 transparent instances, 353,920 triangles, 640x360

``obj`` is an OBJ file written by :func:`teapot_obj` (gen_mesh.py).
"""

from __future__ import annotations

import math
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def teapot_obj(out_dir, seed: int = 0) -> Path:
    """Write the 6,320-triangle stand-in for teapot.obj; returns its path."""
    from benchmarks.gen_mesh import obj_text

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "teapot.obj"
    path.write_text(obj_text(seed))
    return path


def dragons(obj):
    """(camera, scene) of the dragons-equivalent YAML with ``obj``."""
    from raytracer_tpu.scene.yaml_scene import parse_scene

    text = (ROOT / "benchmarks/dragons_equiv.yaml").read_text()
    return parse_scene(text, obj_files=[str(obj)])


def glass_mesh(obj, w: int = 640, h: int = 360, n: int = 56):
    """56 glass instances over a plane: the transparent-mesh path
    (candidate table, nearest-behind query, n1/n2 walk)."""
    from raytracer_tpu import transforms as tf
    from raytracer_tpu.camera import Camera
    from raytracer_tpu.obj import parse_obj
    from raytracer_tpu.scene import specs as S
    from raytracer_tpu.scene.builder import build_scene

    src = Path(obj).read_text()
    glass = S.Material(color=(0.05, 0.05, 0.08), transparency=0.9,
                       refractive_index=1.5, diffuse=0.1, ambient=0.02,
                       specular=0.9, shininess=300.0)
    items = [S.PointLight(position=(-10.0, 20.0, -10.0)),
             S.Plane(material=S.Material(specular=0.0))]
    for i in range(n):
        g = parse_obj(src, glass)
        g.transform = (
            tf.translation(-8.0 + 2.0 * (i % 9), 0.0, 3.0 + 2.5 * (i // 9))
            @ tf.rotation_y(0.5 * i) @ tf.scaling(0.12, 0.12, 0.12)
        )
        items.append(g)
    scene = build_scene(items)
    cam = Camera(w, h, math.pi / 3).with_transform(
        tf.view_transform((0, 4.0, -12.0), (0, 1.0, 2.0), (0, 1, 0)))
    return cam, scene

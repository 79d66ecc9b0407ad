"""CLI smoke test (in-process main(), mirrors main.rs flows)."""

import numpy as np

from raytracer_tpu.__main__ import main
from raytracer_tpu.canvas import from_ppm_bytes

SCENE = """
- add: camera
  width: 16
  height: 10
  field-of-view: PI/3
  from: [0, 1.5, -5]
  to: [0, 1, 0]
  up: [0, 1, 0]
- add: point-light
  at: [-10, 10, -10]
  intensity: [1, 1, 1]
- add: plane
- add: sphere
  transform:
    - [translate, -0.5, 1, 0.5]
  material:
    color: [0.1, 0.4, 0.9]
"""


def test_cli_render_to_file(tmp_path):
    scene_p = tmp_path / "scene.yaml"
    scene_p.write_text(SCENE)
    out_p = tmp_path / "out.ppm"
    rc = main(["--scene", str(scene_p), "--out", str(out_p)])
    assert rc == 0
    img = from_ppm_bytes(out_p.read_bytes())
    assert img.shape == (10, 16, 3)
    assert img.max() > 0.1


def test_cli_default_tile_is_adaptive(tmp_path, monkeypatch):
    """The CLI must not pin tile_rays: mesh-heavy scenes rely on render()'s
    adaptive small screen-local tiles."""
    from raytracer_tpu.core.render import pick_tile_rays
    from raytracer_tpu.core.types import SceneStatic

    seen = {}
    import raytracer_tpu.core.render as rr
    orig = rr.render

    def spy(scene, camera, *, tile_rays=None, **kw):
        seen["tile_rays"] = tile_rays
        return orig(scene, camera, tile_rays=tile_rays, **kw)

    monkeypatch.setattr(rr, "render", spy)
    scene_p = tmp_path / "scene.yaml"
    scene_p.write_text(SCENE)
    rc = main(["--scene", str(scene_p), "--out", str(tmp_path / "o.ppm")])
    assert rc == 0
    assert seen["tile_rays"] is None  # adaptive path engaged

    # and the adaptive choice picks smaller tiles for mesh-heavy scenes
    # (assert the contract — ordering + power-of-two — not the swept
    # constants, which a re-sweep may move)
    mesh_static = SceneStatic(counts=(0, 0, 0, 0, 0, 30000))
    small_static = SceneStatic(counts=(2, 1, 0, 0, 0, 0))
    mesh_tile = pick_tile_rays(mesh_static)
    small_tile = pick_tile_rays(small_static)
    assert mesh_tile < small_tile
    assert mesh_tile & (mesh_tile - 1) == 0
    assert small_tile & (small_tile - 1) == 0


def test_cli_dithering(tmp_path):
    scene_p = tmp_path / "scene.yaml"
    scene_p.write_text(SCENE)
    out_p = tmp_path / "out.ppm"
    rc = main(["--scene", str(scene_p), "--dithering", "bayer2",
               "--out", str(out_p)])
    assert rc == 0
    img = from_ppm_bytes(out_p.read_bytes())
    assert set(np.unique(img)) <= {0.0, 1.0}

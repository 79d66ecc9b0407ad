"""Per-pixel parity against the reference's committed renders.

The Rust renderer's samples/rendered/*.png are the correctness oracle
(BASELINE.md). Rendering whole frames on the CPU test mesh is slow, so
each scene renders three 8-row bands and compares u8 pixels; the full
frames need the reference renders, which are not in the repository; the
tests skip without them.
"""

from pathlib import Path

import numpy as np
import pytest

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None

from raytracer_tpu.canvas import quantize_u8
from raytracer_tpu.core.render import color_at
from raytracer_tpu.camera import ray_grid
from raytracer_tpu.scene.yaml_scene import parse_scene

SCENES = Path("/root/reference/samples/scenes")
RENDERED = Path("/root/reference/samples/rendered")
OBJS = list(Path("/root/reference/samples/obj").glob("*.obj"))

pytestmark = pytest.mark.skipif(
    Image is None or not RENDERED.exists(), reason="reference assets missing"
)


def render_bands(name, bands):
    cam, scene = parse_scene(
        (SCENES / f"{name}.yaml").read_text(), obj_files=OBJS
    )
    ref = np.asarray(Image.open(RENDERED / f"{name}.png").convert("RGB"))
    origins, directions = ray_grid(cam)
    h, w = cam.vsize, cam.hsize
    assert ref.shape == (h, w, 3)
    results = []
    for y0 in bands:
        rows = slice(y0 * w, (y0 + 8) * w)
        img = np.asarray(color_at(scene, origins[rows], directions[rows]))
        ours = quantize_u8(img.reshape(8, w, 3))
        results.append((ours, ref[y0 : y0 + 8]))
    return results


@pytest.mark.parametrize("name,bands", [
    ("basic_scene", (180, 360, 600)),
    ("csg", (300, 360, 420)),
    ("checkered_plane", (120, 250, 350)),
    ("checkered_cube", (100, 200, 300)),
    ("checkered_cylinder", (100, 200, 300)),
    ("checkered_sphere", (100, 200, 300)),
    ("cover", (300, 640, 900)),
    ("space_ship", (200, 360, 520)),
    ("space_teapot", (250, 400, 550)),
])
def test_band_parity(name, bands):
    for ours, ref in render_bands(name, bands):
        diff = np.abs(ours.astype(int) - ref.astype(int)).max(-1)
        exact = (diff == 0).mean()
        assert exact >= 0.995, (name, exact, diff.max())


@pytest.mark.parametrize("name", [
    "basic_scene", "csg", "checkered_plane", "checkered_cube",
    "checkered_cylinder", "checkered_sphere", "cover", "space_ship",
    "space_teapot",
])
def test_scattered_row_parity(name):
    """Eight single rows spread evenly over the FULL frame height (plus a
    golden-ratio column phase so successive rows don't align), rendered
    as one batch: a regression confined to rows outside the three fixed
    bands of test_band_parity (e.g. a tiling bug) cannot hide from this.
    Costs the same as one extra 8-row band per scene."""
    cam, scene = parse_scene(
        (SCENES / f"{name}.yaml").read_text(), obj_files=OBJS
    )
    ref = np.asarray(Image.open(RENDERED / f"{name}.png").convert("RGB"))
    origins, directions = ray_grid(cam)
    h, w = cam.vsize, cam.hsize
    rows = [(i * h) // 9 + (i * 37) % 7 for i in range(1, 9)]
    idx = np.concatenate([np.arange(y * w, (y + 1) * w) for y in rows])
    img = np.asarray(color_at(scene, origins[idx], directions[idx]))
    ours = quantize_u8(img.reshape(len(rows), w, 3))
    band = ref[np.asarray(rows)]
    diff = np.abs(ours.astype(int) - band.astype(int)).max(-1)
    exact = (diff == 0).mean()
    assert exact >= 0.995, (name, exact, diff.max())


def test_soft_shadows_statistical_envelope():
    """soft_shadows uses unseeded RNG jitter in the reference
    (lights.rs:114-120), so per-pixel equality is not defined; assert the
    seeded stochastic render stays inside a tight statistical envelope of
    the committed reference image."""
    import jax

    cam, scene = parse_scene(
        (SCENES / "soft_shadows.yaml").read_text(), obj_files=OBJS
    )
    ref = np.asarray(Image.open(RENDERED / "soft_shadows.png").convert("RGB"))
    origins, directions = ray_grid(cam)
    w = cam.hsize
    y0 = 200
    rows = slice(y0 * w, (y0 + 8) * w)
    img = np.asarray(color_at(
        scene, origins[rows], directions[rows], key=jax.random.PRNGKey(0)
    ))
    ours = quantize_u8(img.reshape(8, w, 3)).astype(int)
    band = ref[y0 : y0 + 8].astype(int)
    diff = np.abs(ours - band)
    assert diff.mean() < 2.0, diff.mean()
    assert (diff <= 8).mean() > 0.99, (diff > 8).mean()

"""CLI: YAML scene in → ASCII PPM out (mirrors /root/reference/src/main.rs).

    python -m raytracer_tpu --scene scene.yaml [--obj m.obj ...]
        [--ppm tex.ppm ...] [--dithering bayer4] [--out out.ppm]
"""

from __future__ import annotations

import argparse
import sys

from raytracer_tpu.scene.yaml_scene import render_scene_file

DITHER_CHOICES = ("bayer2", "bayer4", "bayer8", "bayer16", "bayer-color")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="raytracer_tpu", description="The Ray Tracer Challenge CLI"
    )
    parser.add_argument("--scene", required=True, metavar="FILE",
                        help="A yaml description of the scene to render")
    parser.add_argument("--obj", action="append", default=[], metavar="FILE",
                        help="Optional obj models to add to the scene")
    parser.add_argument("--ppm", action="append", default=[], metavar="FILE",
                        help="Optional ppm textures to use as material")
    parser.add_argument("--dithering", choices=DITHER_CHOICES, metavar="PARAMS",
                        help="Add dithering effect to the final image")
    parser.add_argument("--out", metavar="FILE",
                        help="Optional output ppm file, defaults to stdout")
    parser.add_argument("--tile-rays", type=int, default=None,
                        help="Rays per device dispatch (memory/perf knob); "
                             "default picks adaptively (small screen-local "
                             "tiles for mesh-heavy scenes)")
    args = parser.parse_args(argv)

    canvas = render_scene_file(
        args.scene,
        obj_files=args.obj,
        ppm_files=args.ppm,
        dithering=args.dithering,
        tile_rays=args.tile_rays,
    )
    if args.out:
        with open(args.out, "wb") as f:
            canvas.to_ppm(f)
    else:
        canvas.to_ppm(sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Headline benchmark matrix.

Headline metric: the dragons-equivalent mesh scene — the same structure,
materials, camera and resolution as the reference's only published perf
anchor (dragons.yaml: 1200x480, ~45 min on a 16-core CPU per the
reference's README => ~213 px/s), with each ~100k-triangle dragon.obj
(external download) replaced by 28 instances of a seeded stand-in for
teapot.obj (1,061,760 smooth triangles total; benchmarks/gen_mesh.py,
benchmarks/scenes.py). ``vs_baseline`` = dragons-equivalent px/s over the
reference's 213 px/s (same resolution, same scene class).

Also reported (in "matrix"): the flagship 3-sphere glass scene at
1280x720 depth-4, soft_shadows (10x10 area light = 100 shadow rays/hit),
a transparent 354k-triangle mesh scene, forward+backward training-step
throughput (rays/s through render + MSE grad + SGD update — the
BASELINE.json target is rays/sec/chip forward+backward), total traced
rays/s, and a cost_analysis-based roofline estimate (caveat: XLA's
"bytes accessed" overcounts gather operands; treat GB/s as an upper
bound).

Usage: python bench.py [--smoke]
"""

import json
import math
import sys
import time
from pathlib import Path

import numpy as np

BASELINE_PX_PER_SEC = 576000 / 2700.0  # dragons.yaml: 1200*480 px / ~45 min

REF = Path("/root/reference/samples")
REPO = Path(__file__).resolve().parent


def median_time(fn, iters=5):
    """Min-of-N frame time (ROADMAP S2: report the median and a high
    percentile instead)."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return min(times), out


def rays_per_pixel(scene):
    """Statically-known traced rays per pixel: the wavefront integrator
    spawns (reflect?+refract?) child streams per level, and every
    stream-ray traces 1 primary + 1 shadow ray per point light + us*vs
    shadow rays per area light."""
    st = scene.static
    n_point = int(scene.plight_pos.shape[0])
    shadow_per_ray = n_point + sum(us * vs for us, vs in st.area_steps)
    n_spawn = int(st.has_reflective) + int(st.has_transparency)
    if not getattr(st, "has_blend", True):
        # merged spawn streams: level width stays constant (render.color_at)
        n_spawn = min(n_spawn, 1)
    total = 0
    streams = 1
    for level in range(st.recursion_limit + 1):
        total += streams * (1 + shadow_per_ray)
        streams *= max(n_spawn, 1)
        if n_spawn == 0:
            break
    return total


def bench_dragons(iters):
    from benchmarks.scenes import dragons, teapot_obj
    from raytracer_tpu.core.render import render

    cam, scene = dragons(teapot_obj(REPO / "out"))
    # quantize=True = the CLI/PPM path (bit-identical u8 output, quantized
    # on device)
    render(scene, cam, quantize=True)  # warm-up/compile
    dt, img = median_time(lambda: render(scene, cam, quantize=True), iters)
    assert np.isfinite(img).all()
    px = cam.hsize * cam.vsize
    return dict(
        px_per_sec=round(px / dt, 1),
        seconds_per_frame=round(dt, 3),
        rays_per_sec=round(px / dt * rays_per_pixel(scene), 1),
        triangles=int(scene.static.counts[5]),
        resolution=f"{cam.hsize}x{cam.vsize}",
    ), cam, scene, dt


def bench_flagship(iters, hsize=1280, vsize=720):
    from __graft_entry__ import _flagship_scene, _camera
    from raytracer_tpu.core.render import render

    scene = _flagship_scene()
    cam = _camera(hsize, vsize)
    render(scene, cam, quantize=True)
    dt, img = median_time(lambda: render(scene, cam, quantize=True), iters)
    assert np.isfinite(img).all()
    px = cam.hsize * cam.vsize
    return dict(
        px_per_sec=round(px / dt, 1),
        seconds_per_frame=round(dt, 3),
        rays_per_sec=round(px / dt * rays_per_pixel(scene), 1),
        resolution=f"{cam.hsize}x{cam.vsize}",
    )


def bench_glass_mesh(iters):
    """Transparent mesh at scale: 56 glass instances (353,920 smooth
    triangles, transparency 0.9 / ri 1.5) — drives the hardest semantic
    path (free-mesh candidate columns + nearest-behind + n1/n2 walk) at
    640x360 depth-4."""
    from benchmarks.scenes import glass_mesh, teapot_obj
    from raytracer_tpu.core.render import render

    cam, scene = glass_mesh(teapot_obj(REPO / "out"))
    assert scene.static.mesh_transparent
    render(scene, cam, quantize=True)
    dt, img = median_time(lambda: render(scene, cam, quantize=True), iters)
    assert np.isfinite(img.astype(np.float32)).all()
    px = cam.hsize * cam.vsize
    return dict(
        px_per_sec=round(px / dt, 1),
        seconds_per_frame=round(dt, 3),
        triangles=int(scene.static.counts[5]),
        resolution=f"{cam.hsize}x{cam.vsize}",
    )


def bench_train_step(iters):
    """Forward+backward rays/s (the BASELINE.json target is rays/sec/chip
    forward+backward): one jitted SGD step on every float scene table of
    the flagship scene — render + MSE loss + grads + update — over a
    128k-ray batch."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship_scene, _camera
    from raytracer_tpu.camera import ray_grid
    from raytracer_tpu.parallel.train import train_step

    scene = _flagship_scene()
    cam = _camera(512, 256)                     # 131072 rays
    origins, directions = ray_grid(cam)
    o = jnp.asarray(origins)
    d = jnp.asarray(directions)
    target = jnp.zeros((o.shape[0], 3))

    # 4 gradient-accumulation microbatches, remat off — exact same
    # gradients as the full-batch step (test_microbatch_matches_full_
    # batch); whether it is the fastest point on the GPU is ROADMAP S7.
    step = jax.jit(lambda s, o, d, t: train_step(
        s, o, d, t, lr=1e-3, n_micro=4, remat=False))
    loss, _ = step(scene, o, d, target)         # compile
    assert np.isfinite(float(loss))

    def run():
        loss, s2 = step(scene, o, d, target)
        return float(loss)

    dt, _ = median_time(run, iters)
    n = o.shape[0]
    return dict(
        rays_per_sec_fwd_bwd=round(n / dt, 1),
        seconds_per_step=round(dt, 4),
        batch_rays=int(n),
        config="n_micro=4, remat=False",
    )


def bench_soft_shadows(iters):
    import jax
    from raytracer_tpu.scene.yaml_scene import parse_scene
    from raytracer_tpu.core.render import render

    cam, scene = parse_scene((REF / "scenes/soft_shadows.yaml").read_text())
    key = jax.random.PRNGKey(0)
    render(scene, cam, key=key, quantize=True)
    dt, img = median_time(
        lambda: render(scene, cam, key=key, quantize=True), iters
    )
    assert np.isfinite(img).all()
    px = cam.hsize * cam.vsize
    return dict(
        px_per_sec=round(px / dt, 1),
        seconds_per_frame=round(dt, 3),
        rays_per_sec=round(px / dt * rays_per_pixel(scene), 1),
        resolution=f"{cam.hsize}x{cam.vsize}",
    )


def bench_csg_area_light(iters):
    """csg.yaml's 6-primitive CSG tree lit by soft_shadows.yaml's 10x10
    area light (100 shadow rays per shading point) at 640x360 depth-4:
    the CSG x area-light combination runs the factored shadow path
    (quadric + dense CSG columns through apply_csg on the flat [R*S, C]
    t-table) instead of materializing full candidate tables per sample."""
    import jax
    from raytracer_tpu.scene.yaml_scene import parse_scene
    from raytracer_tpu.core.render import render

    src = (REF / "scenes/csg.yaml").read_text()
    src = src.replace(
        "- add: point-light\n  at: [-10, 10, -10]\n  intensity: [1, 1, 1]",
        "- add: area-light\n  corner: [-1, 2, 4]\n  uvec: [2, 0, 0]\n"
        "  vvec: [0, 2, 0]\n  usteps: 10\n  vsteps: 10\n"
        "  intensity: [1.5, 1.5, 1.5]",
    ).replace("width: 1280", "width: 640").replace("height: 720",
                                                   "height: 360")
    cam, scene = parse_scene(src)
    assert scene.static.area_steps == ((10, 10),)
    assert scene.static.csg_nodes
    key = jax.random.PRNGKey(0)
    render(scene, cam, key=key, quantize=True)
    dt, img = median_time(
        lambda: render(scene, cam, key=key, quantize=True), iters
    )
    assert np.isfinite(img.astype(np.float32)).all()
    px = cam.hsize * cam.vsize
    return dict(
        px_per_sec=round(px / dt, 1),
        seconds_per_frame=round(dt, 3),
        shadow_rays_per_hit=100,
        resolution=f"{cam.hsize}x{cam.vsize}",
    )


def roofline_estimate(cam, scene, frame_dt):
    """FLOP/s and memory GB/s achieved on the dragons tile program, from the
    compiled executable's cost analysis. Bytes include XLA's per-element
    gather operand accounting, so GB/s is an UPPER bound on real traffic."""
    import jax
    from raytracer_tpu.core.render import _color_at_jit, pick_tile_rays

    try:
        tile = pick_tile_rays(scene.static)
        o = np.zeros((tile, 3), np.float32)
        d = np.tile(np.array([0, 0, 1], np.float32), (tile, 1))
        key = jax.random.PRNGKey(0)
        lowered = _color_at_jit.lower(
            scene, o, d, key, scene.static.recursion_limit
        )
        cost = lowered.compile().cost_analysis()
        if isinstance(cost, list):
            cost = cost[0]
        n_tiles = -(-cam.hsize * cam.vsize // tile)
        flops = float(cost.get("flops", 0.0)) * n_tiles
        byts = float(cost.get("bytes accessed", 0.0)) * n_tiles
        return dict(
            gflops_per_sec=round(flops / frame_dt / 1e9, 1),
            gbytes_per_sec_upper_bound=round(byts / frame_dt / 1e9, 1),
            flops_per_byte=round(flops / max(byts, 1.0), 3),
        )
    except Exception as e:  # cost analysis unavailable on some backends
        return dict(error=str(e)[:120])


def _section(fn, *args):
    """Run one bench section in isolation: a failure (OOM, regression)
    becomes an {ok: False, error} row instead of destroying the record of
    every other section (round 3 lost its entire artifact to one OOM)."""
    import traceback

    try:
        out = fn(*args)
        if isinstance(out, dict):
            out.setdefault("ok", True)
        return out
    except Exception as e:
        tb = traceback.format_exc().strip().splitlines()
        return {"ok": False, "error": f"{type(e).__name__}: {e}"[:400],
                "error_at": tb[-2][:200] if len(tb) >= 2 else ""}


def main():
    smoke = "--smoke" in sys.argv
    if smoke:
        flag = bench_flagship(1, hsize=64, vsize=36)
        print(json.dumps({
            "metric": "smoke_flagship_px_per_sec",
            "value": flag["px_per_sec"],
            "unit": "pixels/sec",
            "vs_baseline": round(flag["px_per_sec"] / BASELINE_PX_PER_SEC, 2),
        }))
        return

    headline = _section(bench_dragons, 9)
    if isinstance(headline, tuple):  # success: (dict, cam, scene, dt)
        dragons, cam, scene, dt = headline
        dragons.setdefault("ok", True)
    else:  # _section error dict
        dragons, cam, scene, dt = headline, None, None, None

    flagship = _section(bench_flagship, 5)
    soft = _section(bench_soft_shadows, 3)
    csg_al = _section(bench_csg_area_light, 3)
    glass = _section(bench_glass_mesh, 3)
    train = _section(bench_train_step, 3)
    roof = (
        _section(roofline_estimate, cam, scene, dt)
        if cam is not None
        else {"ok": False, "error": "dragons section failed"}
    )

    ok = isinstance(dragons, dict) and dragons.get("ok", False)
    print(json.dumps({
        "metric": "dragons_equiv_1.06M_tris_px_per_sec_1200x480_depth4",
        "value": dragons.get("px_per_sec") if ok else None,
        "unit": "pixels/sec",
        "vs_baseline": (
            round(dragons["px_per_sec"] / BASELINE_PX_PER_SEC, 2) if ok else None
        ),
        "matrix": {
            "dragons_equiv": dragons,
            "flagship_1280x720": flagship,
            "soft_shadows": soft,
            "csg_area_light_10x10": csg_al,
            "glass_mesh_354k_tris": glass,
            "train_step_fwd_bwd": train,
            "roofline_dragons": roof,
            "baseline_px_per_sec": round(BASELINE_PX_PER_SEC, 1),
        },
    }))
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()

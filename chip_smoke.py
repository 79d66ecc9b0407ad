#!/usr/bin/env python3
"""Bring-up smoke test: the renderer's main path on an NVIDIA GPU.

    python chip_smoke.py [--seed N]       # one GPU: every phase below
    python chip_smoke.py --four-gpus      # the sharded path on four GPUs

One process. Each phase prints one JSON line with its numbers; any failed
check raises, so the script exits non-zero. Phases on one GPU:

  device    JAX's devices, version, XLA_FLAGS, compile cache, the card
  asset     a seeded stand-in for teapot.obj (benchmarks/gen_mesh.py)
  dragons   benchmarks/dragons_equiv.yaml (1,061,760 triangles, 1200x480,
            depth 4) through the CLI, then warm render() frames
  kernel    the mesh kernel against the scan on one primary tile and its
            shadow rays at dragons widths
  parity    GPU against CPU images at reduced size: at most 0.5% of pixels
            may differ by more than one u8 step
  flagship, glass_mesh, train_step, mesh_grad   the rest of the main path

The last line is {"ok": true, "device": {...}}. Without a GPU, or without
the repository around it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "out"
PARITY_BAR = 0.005          # share of pixels more than one u8 step off
DRAGONS_TRIS = 1_061_760


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def stats(times):
    import numpy as np

    return {"median_s": float(np.median(times)),
            "p90_s": float(np.percentile(times, 90)), "n": len(times),
            "all_s": [float(t) for t in times]}


def timed(fn, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


def resized(cam, w, h):
    from raytracer_tpu.camera import Camera

    return Camera(w, h, cam.field_of_view).with_transform(cam.transform)


def peak_bytes(device):
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", -1))


@contextlib.contextmanager
def scan_path():
    """Run the mesh queries through the scan on the GPU too (the kernel's
    reference), then restore the per-platform choice."""
    import jax
    from raytracer_tpu.core import intersect as I

    keep = I._by_platform
    I._by_platform = lambda gpu, default: default()
    jax.clear_caches()
    try:
        yield
    finally:
        I._by_platform = keep
        jax.clear_caches()


# --- scenes -------------------------------------------------------------

def flagship(w=1280, h=720):
    from __graft_entry__ import _camera, _flagship_scene

    return _camera(w, h), _flagship_scene()


# --- phases -------------------------------------------------------------

def phase_device(jax):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else (
        "nvidia-smi failed: " + smi.stderr.strip())
    emit("device", devices=[str(d) for d in jax.devices()],
         jax=jax.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""),
         compile_cache=jax.config.jax_compilation_cache_dir, card=card)
    return card


def phase_asset(seed):
    from benchmarks.scenes import teapot_obj

    path = teapot_obj(OUT, seed)
    n = sum(1 for line in path.read_text().splitlines()
            if line.startswith("f "))
    assert n == 6320, n
    emit("asset", path=str(path.relative_to(ROOT)), seed=seed, triangles=n)
    return path


def phase_dragons(obj):
    import numpy as np
    from benchmarks.scenes import dragons
    from raytracer_tpu.__main__ import main as cli
    from raytracer_tpu.canvas import from_ppm_bytes
    from raytracer_tpu.core.render import render

    ppm = OUT / "dragons.ppm"
    t0 = time.perf_counter()
    rc = cli(["--scene", str(ROOT / "benchmarks/dragons_equiv.yaml"),
              "--obj", str(obj), "--out", str(ppm)])
    cold = time.perf_counter() - t0
    data = ppm.read_bytes()
    assert rc == 0 and data.startswith(b"P3\n1200 480\n255\n"), data[:20]
    img = from_ppm_bytes(data)
    assert img.shape == (480, 1200, 3), img.shape
    assert img.std() > 0.05 and img.max() > 0.5, (img.std(), img.max())

    t0 = time.perf_counter()
    cam, scene = dragons(obj)
    build = time.perf_counter() - t0
    tris = int(scene.static.counts[5])
    assert tris == DRAGONS_TRIS, tris
    frame = render(scene, cam, quantize=True)
    assert (frame == np.round(img * 255)).all()   # same image as the CLI's
    times = timed(lambda: render(scene, cam, quantize=True), 5)
    emit("dragons", cold_cli_s=cold, build_s=build, triangles=tris,
         resolution="1200x480", frame=stats(times),
         px_per_s=1200 * 480 / float(np.median(times)))
    return cam, scene


def phase_kernel(jax, cam, scene):
    """One 16,384-ray primary tile of the dragons frame (the middle one)
    and its shadow rays, kernel against scan on the card."""
    import jax.numpy as jnp
    import numpy as np
    from raytracer_tpu.core import intersect as I
    from raytracer_tpu.core.render import _order_tiles, camera_consts, tile_rays

    _, idx_tiles = _order_tiles(cam.vsize, cam.hsize, 16384)
    inv, consts = camera_consts(cam)
    o, d = tile_rays(inv, consts, idx_tiles[idx_tiles.shape[0] // 2],
                     cam.hsize)
    kern = jax.jit(I._tri_free_nearest_gpu, static_argnames="any_hit")
    scan = jax.jit(I._tri_free_nearest_scan)

    def run(fn, *a, **k):
        fn(scene, *a, **k)[0].block_until_ready()           # compile
        t0 = time.perf_counter()
        out = fn(scene, *a, **k)
        out[0].block_until_ready()
        return [np.asarray(x) for x in out], time.perf_counter() - t0

    def compare(name, a, b):
        (tk, gk, _, _), (ts, gs, _, _) = a, b
        hit = np.isfinite(ts)
        assert (np.isfinite(tk) == hit).all(), f"{name}: misses differ"
        rel = np.abs(tk[hit] - ts[hit]) / ts[hit]
        differ = hit & (gk != gs)
        tie = np.abs(tk[differ] - ts[differ]) <= 1e-5 * ts[differ]
        assert tie.all(), f"{name}: {int((~tie).sum())} index mismatches"
        return dict(hits=int(hit.sum()), max_rel_t=float(rel.max(initial=0)),
                    index_ties=int(differ.sum()))

    prim_k, t_pk = run(kern, o, d)
    prim_s, t_ps = run(scan, o, d)
    prim = compare("primary", prim_k, prim_s)

    hit = np.isfinite(prim_s[0])
    t = np.where(hit, prim_s[0], 1.0)
    p = np.asarray(o) + (t - 1e-3 * np.maximum(t, 1.0))[:, None] * np.asarray(d)
    to_light = np.asarray(scene.plight_pos[0]) - p
    dist = np.linalg.norm(to_light, axis=1)
    so = jnp.asarray(np.where(hit[:, None], p, 3e8), jnp.float32)
    sd = jnp.asarray(np.where(hit[:, None], to_light / dist[:, None],
                              [0.0, 0.0, 1.0]), jnp.float32)
    cap = jnp.asarray(np.where(hit, dist, 0.0), jnp.float32)
    sh_k, t_sk = run(kern, so, sd, cap)
    sh_s, t_ss = run(scan, so, sd, cap)
    shadow = compare("shadow", sh_k, sh_s)
    any_k, t_ak = run(kern, so, sd, cap, any_hit=True)
    assert (np.isfinite(any_k[0]) == np.isfinite(sh_s[0])).all()
    emit("kernel", rays=int(o.shape[0]), primary=prim, shadow=shadow,
         primary_kernel_s=t_pk, primary_scan_s=t_ps,
         shadow_kernel_s=t_sk, shadow_scan_s=t_ss, shadow_any_hit_s=t_ak)


def phase_parity(jax, obj):
    """GPU against the CPU path (the scan) in one process, at reduced size.
    The CPU renders use small tiles: the scan culls per tile."""
    import numpy as np
    from benchmarks.scenes import dragons, glass_mesh
    from raytracer_tpu.core.render import render

    cpu = jax.devices("cpu")[0]
    cam_d, sc_d = dragons(obj)
    cases = {
        "dragons_240x96": (resized(cam_d, 240, 96), sc_d),
        "flagship_160x90": flagship(160, 90),
        "glass_mesh_128x72": glass_mesh(obj, 128, 72),
    }
    for name, (cam, scene) in cases.items():
        t0 = time.perf_counter()
        img_g = render(scene, cam, quantize=True)
        t_g = time.perf_counter() - t0
        t0 = time.perf_counter()
        with jax.default_device(cpu):
            img_c = render(jax.device_put(scene, cpu), cam, quantize=True,
                           tile_rays=256)
        t_c = time.perf_counter() - t0
        diff = np.abs(img_g.astype(np.int16) - img_c.astype(np.int16))
        off = float((diff.max(-1) > 1).mean())
        emit("parity", scene=name, off_share=off, bar=PARITY_BAR,
             max_step=int(diff.max()), gpu_s=t_g, cpu_s=t_c)
        assert off <= PARITY_BAR, (name, off)
        assert img_g.std() > 5, (name, float(img_g.std()))


def frame_phase(name, cam, scene, build_s=None):
    import numpy as np
    from raytracer_tpu.core.render import render

    t0 = time.perf_counter()
    img = render(scene, cam, quantize=True)
    cold = time.perf_counter() - t0
    assert img.std() > 5, float(img.std())
    times = timed(lambda: render(scene, cam, quantize=True), 5)
    emit(name, resolution=f"{cam.hsize}x{cam.vsize}",
         triangles=int(scene.static.counts[5]), build_s=build_s,
         cold_s=cold, frame=stats(times),
         px_per_s=cam.hsize * cam.vsize / float(np.median(times)))


def phase_train(jax):
    import jax.numpy as jnp
    import numpy as np
    from raytracer_tpu.camera import ray_grid
    from raytracer_tpu.parallel.train import train_step

    cam, scene = flagship(512, 256)                         # 131,072 rays
    o, d = (jnp.asarray(x) for x in ray_grid(cam))
    target = jnp.zeros((o.shape[0], 3))
    step = jax.jit(lambda s, o, d, t: train_step(
        s, o, d, t, lr=1e-3, n_micro=4, remat=False))
    t0 = time.perf_counter()
    loss, _ = step(scene, o, d, target)
    loss = float(loss)
    cold = time.perf_counter() - t0
    assert np.isfinite(loss)
    times = timed(lambda: float(step(scene, o, d, target)[0]), 3)
    emit("train_step", rays=int(o.shape[0]), config="n_micro=4, remat=False",
         loss=loss, cold_s=cold, step=stats(times),
         rays_per_s=o.shape[0] / float(np.median(times)))


def small_mesh(obj, w=64, h=48):
    """One reflective stand-in teapot (6,320 triangles) on a plane."""
    from raytracer_tpu import transforms as tf
    from raytracer_tpu.camera import Camera
    from raytracer_tpu.obj import parse_obj
    from raytracer_tpu.scene import specs as S
    from raytracer_tpu.scene.builder import build_scene

    g = parse_obj(Path(obj).read_text(), S.Material(color=(0.8, 0.4, 0.2),
                                                    reflective=0.2))
    g.transform = tf.rotation_x(-math.pi / 2) @ tf.scaling(0.1, 0.1, 0.1)
    scene = build_scene([g, S.Plane(material=S.Material(specular=0.0)),
                         S.PointLight(position=(-10.0, 10.0, -10.0))])
    cam = Camera(w, h, math.pi / 3).with_transform(
        tf.view_transform((0, 2.0, -5.0), (0, 0.7, 0), (0, 1, 0)))
    return cam, scene


def phase_mesh_grad(jax, obj):
    """Gradients of the training loss on a small mesh scene: kernel path
    against the scan, both on the card."""
    import jax.numpy as jnp
    import numpy as np
    from raytracer_tpu.camera import ray_grid
    from raytracer_tpu.parallel.train import partition_scene, render_loss

    cam, scene = small_mesh(obj)
    o, d = (jnp.asarray(x) for x in ray_grid(cam))
    target = jnp.full((o.shape[0], 3), 0.3)
    params, recombine = partition_scene(scene)

    def grads():
        f = jax.jit(jax.value_and_grad(
            lambda p: render_loss(p, recombine, o, d, target, remat=False)))
        loss, gr = f(params)
        return float(loss), {k: np.asarray(v) for k, v in gr.items()}

    loss_k, g_k = grads()
    with scan_path():
        loss_s, g_s = grads()
    worst = 0.0
    for k in g_s:
        assert np.isfinite(g_k[k]).all(), k
        scale = max(float(np.abs(g_s[k]).max(initial=0)), 1e-30)
        err = float(np.abs(g_k[k] - g_s[k]).max(initial=0)) / scale
        worst = max(worst, err)
        np.testing.assert_allclose(g_k[k], g_s[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
    np.testing.assert_allclose(loss_k, loss_s, rtol=1e-4)
    emit("mesh_grad", triangles=int(scene.static.counts[5]),
         rays=int(o.shape[0]), loss_kernel=loss_k, loss_scan=loss_s,
         max_rel_err=worst, tables=sorted(g_s))


def phase_four(jax, obj):
    """render_sharded of the dragons frame and the sharded train step on a
    small mesh scene, four GPUs against one."""
    import jax.numpy as jnp
    import numpy as np
    from benchmarks.scenes import dragons
    from raytracer_tpu.camera import ray_grid
    from raytracer_tpu.core.render import render
    from raytracer_tpu.parallel.mesh import (
        make_mesh, render_sharded, replicate_scene, shard_rays)
    from raytracer_tpu.parallel.train import (
        make_sharded_train_step, partition_scene, train_step)

    devs = jax.devices()
    assert len(devs) == 4, devs
    mesh = make_mesh(devs)
    cam, scene = dragons(obj)
    one = render(scene, cam, quantize=True)
    times = {}
    for n in ("cold", "warm"):
        t0 = time.perf_counter()
        four = render_sharded(scene, cam, mesh)
        times[n] = time.perf_counter() - t0
    four = np.floor(np.clip(four, 0.0, 1.0) * 255.0 + 0.5).astype(np.int16)
    off = float((np.abs(four - one).max(-1) > 1).mean())
    emit("render_sharded", devices=4, off_share=off, bar=PARITY_BAR,
         sharded_cold_s=times["cold"], sharded_warm_s=times["warm"])
    assert off <= PARITY_BAR, off

    cam, scene = small_mesh(obj, 128, 64)                  # 8,192 rays
    o, d = (jnp.asarray(x) for x in ray_grid(cam))
    target = jnp.full((o.shape[0], 3), 0.3)
    lr = 1e-3
    loss1, s1 = jax.jit(lambda s, o, d, t: train_step(
        s, o, d, t, lr=lr, remat=False))(scene, o, d, target)
    so, sd, _ = shard_rays(o, d, mesh)
    st = jax.device_put(target, so.sharding)
    step = make_sharded_train_step(mesh, lr=lr, remat=False)
    loss4, s4 = step(replicate_scene(scene, mesh), so, sd, st,
                     jax.random.PRNGKey(0))
    p0, _ = partition_scene(scene)
    g1 = {k: (np.asarray(p0[k]) - np.asarray(v)) / lr
          for k, v in partition_scene(s1)[0].items()}
    g4 = {k: (np.asarray(p0[k]) - np.asarray(v)) / lr
          for k, v in partition_scene(s4)[0].items()}
    np.testing.assert_allclose(float(loss4), float(loss1), rtol=1e-4)
    for k in g1:
        scale = max(float(np.abs(g1[k]).max(initial=0)), 1e-30)
        np.testing.assert_allclose(g4[k], g1[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)
    emit("sharded_train_step", devices=4, rays=int(o.shape[0]),
         loss_one=float(loss1), loss_four=float(loss4))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the generated mesh")
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    if not (ROOT / "raytracer_tpu" / "__init__.py").is_file():
        sys.exit("chip_smoke.py must run from the repository's root")
    sys.path.insert(0, str(ROOT))
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(f"no GPU: JAX's backend is {jax.default_backend()!r}")

    card = phase_device(jax)
    obj = phase_asset(args.seed)
    dev = jax.devices()[0]
    if args.four_gpus:
        phase_four(jax, obj)
    else:
        cam, scene = phase_dragons(obj)
        phase_kernel(jax, cam, scene)
        del cam, scene
        phase_parity(jax, obj)
        t0 = time.perf_counter()
        cam, scene = flagship()
        frame_phase("flagship", cam, scene, time.perf_counter() - t0)
        from benchmarks.scenes import glass_mesh

        t0 = time.perf_counter()
        cam, scene = glass_mesh(obj)
        frame_phase("glass_mesh", cam, scene, time.perf_counter() - t0)
        del cam, scene
        phase_train(jax)
        phase_mesh_grad(jax, obj)
        emit("memory", peak_bytes_in_use=peak_bytes(dev))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()

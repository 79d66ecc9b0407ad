"""Differentiability (finite-difference checks) and multi-device sharding
tests — capabilities beyond the reference (forward-only, single process)."""

import math
import pathlib

import numpy as np
import jax
import jax.numpy as jnp

REPO_ROOT = str(pathlib.Path(__file__).resolve().parents[1])

from raytracer_tpu import transforms as tf
from raytracer_tpu.camera import Camera, ray_grid
from raytracer_tpu.scene import specs as S
from raytracer_tpu.scene.builder import build_scene
from raytracer_tpu.core.render import color_at
from raytracer_tpu.parallel.mesh import make_mesh, render_sharded
from raytracer_tpu.parallel.train import (
    partition_scene, render_loss, train_step, make_sharded_train_step,
)


def small_setup():
    scene = build_scene([
        S.PointLight(position=(-10.0, 10.0, -10.0)),
        S.Plane(material=S.Material(specular=0.0, reflective=0.2)),
        S.Sphere(transform=tf.translation(-0.5, 1.0, 0.5),
                 material=S.Material(color=(0.1, 0.4, 0.9), diffuse=0.7)),
    ])
    cam = Camera(16, 8, math.pi / 3).with_transform(
        tf.view_transform((0, 1.5, -5), (0, 1, 0), (0, 1, 0))
    )
    o, d = ray_grid(cam)
    return scene, cam, o, d


def test_gradient_matches_finite_difference():
    scene, _, o, d = small_setup()
    target = jnp.zeros((o.shape[0], 3))
    params, recombine = partition_scene(scene)

    loss_fn = lambda p: render_loss(p, recombine, o, d, target)
    grads = jax.grad(loss_fn)(params)

    # finite differences on a handful of material entries
    eps = 1e-3
    checked = 0
    # gid 0 = the sphere (family order), gid 1 = the plane
    for (g_idx, col) in [(0, 0), (0, 3), (1, 4)]:  # color.r, ambient, diffuse
        base = params["mat"]
        g_analytic = float(grads["mat"][g_idx, col])
        pp = dict(params)
        pp["mat"] = base.at[g_idx, col].add(eps)
        up = float(loss_fn(pp))
        pp["mat"] = base.at[g_idx, col].add(-eps)
        dn = float(loss_fn(pp))
        g_numeric = (up - dn) / (2 * eps)
        assert abs(g_analytic - g_numeric) < 5e-3 * max(1.0, abs(g_numeric)), (
            g_idx, col, g_analytic, g_numeric)
        checked += 1
    assert checked == 3

    # light intensity gradient
    g_analytic = float(grads["plight_intensity"][0, 0])
    base = params["plight_intensity"]
    pp = dict(params)
    pp["plight_intensity"] = base.at[0, 0].add(eps)
    up = float(loss_fn(pp))
    pp["plight_intensity"] = base.at[0, 0].add(-eps)
    dn = float(loss_fn(pp))
    g_numeric = (up - dn) / (2 * eps)
    assert abs(g_analytic - g_numeric) < 5e-3 * max(1.0, abs(g_numeric))


def test_camera_rays_jax_match_and_grad():
    from raytracer_tpu.camera import ray_grid, ray_grid_jax, view_transform_jax

    scene, cam, _, _ = small_setup()
    o_np, d_np = ray_grid(cam)
    cam_inv = jnp.linalg.inv(view_transform_jax(
        (0.0, 1.5, -5.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0)))
    o_j, d_j = ray_grid_jax(cam_inv, cam.hsize, cam.vsize, cam.field_of_view)
    assert np.allclose(np.asarray(o_j), np.asarray(o_np), atol=1e-5)
    assert np.allclose(np.asarray(d_j), np.asarray(d_np), atol=1e-5)

    # camera-pose gradient: loss of rendered image w.r.t. eye position
    target = jnp.zeros((cam.hsize * cam.vsize, 3))

    def loss(from_p):
        inv = jnp.linalg.inv(view_transform_jax(
            from_p, jnp.asarray([0.0, 1.0, 0.0]), jnp.asarray([0.0, 1.0, 0.0])))
        o, d = ray_grid_jax(inv, cam.hsize, cam.vsize, cam.field_of_view)
        img = color_at(scene, o, d, limit=0)
        return jnp.mean((img - target) ** 2)

    f0 = jnp.asarray([0.0, 1.5, -5.0])
    g = jax.grad(loss)(f0)
    assert np.isfinite(np.asarray(g)).all()
    eps = 1e-2
    for k in range(3):
        up = float(loss(f0.at[k].add(eps)))
        dn = float(loss(f0.at[k].add(-eps)))
        num = (up - dn) / (2 * eps)
        assert abs(float(g[k]) - num) < max(0.3 * abs(num), 5e-3), (k, float(g[k]), num)


def test_train_step_reduces_loss():
    scene, _, o, d = small_setup()
    target = jnp.full((o.shape[0], 3), 0.3)
    loss0, scene1 = train_step(scene, o, d, target, lr=0.005)
    loss1, _ = train_step(scene1, o, d, target, lr=0.005)
    assert float(loss1) < float(loss0)


def test_optax_step():
    import optax
    from raytracer_tpu.parallel.train import make_optax_step

    scene, _, o, d = small_setup()
    target = jnp.full((o.shape[0], 3), 0.25)
    init_fn, step_fn = make_optax_step(
        optax.adam(1e-2), param_filter=lambda k: k == "mat")
    opt_state = init_fn(scene)
    loss0, scene, opt_state = step_fn(scene, opt_state, o, d, target)
    for _ in range(4):
        loss, scene, opt_state = step_fn(scene, opt_state, o, d, target)
    assert float(loss) < float(loss0)


def test_sharded_render_matches_single_device():
    scene, cam, o, d = small_setup()
    img_single = np.asarray(color_at(scene, o, d)).reshape(cam.vsize, cam.hsize, 3)
    mesh = make_mesh(jax.devices()[:8])
    img_sharded = render_sharded(scene, cam, mesh)
    assert np.allclose(img_single, img_sharded, atol=1e-5)


def _float_tables(scene):
    import dataclasses

    out = {}
    for f in dataclasses.fields(scene):
        if f.name == "static":
            continue
        v = getattr(scene, f.name)
        if v is not None and hasattr(v, "dtype") and jnp.issubdtype(
            v.dtype, jnp.floating
        ):
            out[f.name] = np.asarray(v)
    return out


def test_sharded_train_step_matches_single_device():
    """The sharded step's parameter update (i.e. its psum'd gradients)
    must match the single-device update elementwise — not just be finite.
    A sharding-induced wrong gradient fails here."""
    scene, cam, o, d = small_setup()
    mesh = make_mesh(jax.devices()[:8])
    from raytracer_tpu.parallel.mesh import replicate_scene, shard_rays
    so, sd, _ = shard_rays(o, d, mesh)
    scene_r = replicate_scene(scene, mesh)
    target = jnp.zeros((so.shape[0], 3))
    key = jax.random.PRNGKey(0)

    step = make_sharded_train_step(mesh, lr=1e-2)
    loss, scene2 = step(scene_r, so, sd, target, key)
    assert np.isfinite(float(loss))
    # params actually moved
    assert not np.allclose(np.asarray(scene2.mat), np.asarray(scene_r.mat))

    loss_1dev, scene2_1dev = jax.jit(
        lambda s, o, d, t: train_step(s, o, d, t, lr=1e-2, key=key)
    )(scene, jnp.asarray(o), jnp.asarray(d), jnp.zeros((o.shape[0], 3)))
    np.testing.assert_allclose(float(loss), float(loss_1dev), rtol=1e-5)
    ref = _float_tables(scene2_1dev)
    got = _float_tables(scene2)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)

    # per-device gradient-accumulation microbatches: same update again
    step_mb = make_sharded_train_step(mesh, lr=1e-2, n_micro=2)
    loss_mb, scene2_mb = step_mb(scene_r, so, sd, target, key)
    np.testing.assert_allclose(float(loss_mb), float(loss_1dev), rtol=1e-5)
    got_mb = _float_tables(scene2_mb)
    for k in ref:
        np.testing.assert_allclose(got_mb[k], ref[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)

    # remat off (the bench config): same update again
    step_nr = make_sharded_train_step(mesh, lr=1e-2, n_micro=2, remat=False)
    loss_nr, scene2_nr = step_nr(scene_r, so, sd, target, key)
    np.testing.assert_allclose(float(loss_nr), float(loss_1dev), rtol=1e-5)
    got_nr = _float_tables(scene2_nr)
    for k in ref:
        np.testing.assert_allclose(got_nr[k], ref[k], rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_remat_grads_match_exact():
    """Per-level remat (render_loss remat=True, the default) changes only
    what the backward pass stores — gradients must match the no-remat
    path bit-for-bit-ish on the blend flagship scene, whose level width
    growth (16R at depth 4) is what remat exists to bound."""
    import sys
    sys.path.insert(0, REPO_ROOT)
    from __graft_entry__ import _flagship_scene, _camera
    from raytracer_tpu.camera import ray_grid as rg

    scene = _flagship_scene()
    cam = _camera(16, 8)
    o, d = rg(cam)
    o, d = jnp.asarray(o), jnp.asarray(d)
    target = jnp.zeros((o.shape[0], 3))
    params, recombine = partition_scene(scene)

    l0, g0 = jax.value_and_grad(render_loss)(
        params, recombine, o, d, target, None, remat=False)
    l1, g1 = jax.value_and_grad(render_loss)(
        params, recombine, o, d, target, None, remat=True)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-6)
    for k in g0:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g0[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_microbatch_matches_full_batch():
    """Gradient accumulation over n_micro chunks is exact (linearity of
    grads + equal-size MSE chunks): the updated scene must match the
    full-batch update."""
    scene, _, o, d = small_setup()
    o, d = jnp.asarray(o), jnp.asarray(d)
    target = jnp.full((o.shape[0], 3), 0.2)
    loss_a, sc_a = jax.jit(
        lambda s, o, d, t: train_step(s, o, d, t, lr=1e-3))(scene, o, d, target)
    loss_b, sc_b = jax.jit(
        lambda s, o, d, t: train_step(s, o, d, t, lr=1e-3, n_micro=4)
    )(scene, o, d, target)
    np.testing.assert_allclose(float(loss_a), float(loss_b), rtol=1e-5)
    ref, got = _float_tables(sc_a), _float_tables(sc_b)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)

    # remat=False microbatching (the bench's config)
    # must produce the same update too
    loss_c, sc_c = jax.jit(
        lambda s, o, d, t: train_step(
            s, o, d, t, lr=1e-3, n_micro=4, remat=False)
    )(scene, o, d, target)
    np.testing.assert_allclose(float(loss_a), float(loss_c), rtol=1e-5)
    got_c = _float_tables(sc_c)
    for k in ref:
        np.testing.assert_allclose(got_c[k], ref[k], rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_host_mesh_and_multihost_render_path():
    """make_host_mesh shapes (processes, devices); the multihost render path
    (per-host shard materialization + process allgather) must match the
    single-device render even on one process."""
    from raytracer_tpu.parallel.mesh import (
        make_host_mesh, render_sharded, init_distributed,
    )

    pid, pcount = init_distributed()  # no cluster env: safe no-op
    assert pid == 0 and pcount == 1

    scene, cam, o, d = small_setup()
    mesh = make_host_mesh()
    assert mesh.devices.shape[0] == 1  # one process
    img_single = np.asarray(color_at(scene, o, d)).reshape(cam.vsize, cam.hsize, 3)
    img_mh = render_sharded(scene, cam, mesh, multihost=True)
    assert np.allclose(img_single, img_mh, atol=1e-5)


def test_dryrun_multichip_entrypoint():
    import os
    import subprocess
    import sys

    sys.path.insert(0, REPO_ROOT)
    import __graft_entry__ as g
    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()
    # The 8-device dryrun compile runs in a FRESH process: late in a
    # long suite run the same compile SIGABRTs/SIGSEGVs inside XLA:CPU's
    # backend_compile_and_load (reproduced 3x at test ~56 of the suite;
    # the identical compile succeeds in a clean process every time).
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS=env.get("XLA_FLAGS", ""),
        PYTHONPATH=REPO_ROOT,
    )
    r = subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms', 'cpu');"
         "from __graft_entry__ import dryrun_multichip;"
         "dryrun_multichip(8)"],
        capture_output=True, timeout=900, env=env, cwd=REPO_ROOT,
    )
    assert r.returncode == 0, r.stderr[-2000:]


def test_pose_gradient_consistency():
    """with_prim_transform: gradients flow through a primitive's 4x4
    world transform with the inverse and normal matrix recomputed
    in-trace (shading normals stay consistent with the geometry — the
    raw-table gradient surface cannot guarantee that). The analytic
    gradient is the LOCAL shading derivative: it matches central
    finite differences, while silhouette (visibility) changes are
    non-differentiable jumps — full pose recovery from an image loss
    needs visibility-aware gradients (soft rasterization et al.),
    documented as out of scope."""
    import math

    from raytracer_tpu import transforms as tf
    from raytracer_tpu.camera import Camera, ray_grid
    from raytracer_tpu.parallel.train import with_prim_transform

    scene = build_scene([
        S.PointLight(position=(-10.0, 10.0, -10.0)),
        S.Plane(material=S.Material(specular=0.0)),
        S.Sphere(transform=tf.translation(0.0, 1.0, 0.0),
                 material=S.Material(color=(0.8, 0.2, 0.2), diffuse=0.7)),
    ], recursion_limit=1)
    sphere_gid = scene.static.family_range("sphere")[0]

    cam = Camera(48, 32, math.pi / 3).with_transform(
        tf.view_transform((0.0, 1.5, -5.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0)))
    o, d = ray_grid(cam)
    target = color_at(scene, o, d, limit=1)

    def loss(tx):
        m = jnp.eye(4).at[0, 3].set(tx).at[1, 3].set(1.0)
        sc = with_prim_transform(scene, sphere_gid, m)
        img = color_at(sc, o, d, limit=1)
        return jnp.mean((img - target) ** 2)

    # FD only makes sense where the +-eps window does not cross a
    # silhouette jump; tx=0.4 is such a point for this fixed scene/grid
    eps = 1e-3
    tx = 0.4
    g = float(jax.grad(loss)(tx))
    fd = float((loss(tx + eps) - loss(tx - eps)) / (2 * eps))
    assert np.isfinite(g)
    np.testing.assert_allclose(g, fd, rtol=0.15, atol=2e-4)

    # mesh gids are rejected (their vertices are world-space-baked)
    import pytest
    g_nt = sum(scene.static.counts[:5])
    with pytest.raises(ValueError):
        with_prim_transform(scene, g_nt, jnp.eye(4))


# Keep this LAST in the file: XLA:CPU segfaults intermittently when the
# next large compile (e.g. the 8-device dryrun program) follows this
# GB-scale grad compile in the same process (reproduced twice in full
# suite runs; both compile fine in isolation or in the other order).
def test_train_grad_memory_envelope():
    """Compile (AOT, no execution) the full bench train step — flagship
    blend scene, 131,072 rays, depth 4 — and assert the compiled temp
    memory stays bounded. Without per-level remat the grad program grows
    with the spawn tree's width; remat holds the CPU-backend number at
    ~4.6 GB, so 12 GB catches any regression of that class while
    tolerating backend layout differences."""
    import os
    import subprocess
    import sys

    # Runs in a FRESH process (like the dryrun compile above): this
    # GB-scale compile both segfaulted while serializing into the
    # persistent cache (so the child disables the write via an
    # unreachable min-compile-time — the enable_compilation_cache flag
    # does NOT gate _cache_write in jax 0.9.0) and destabilized LATER
    # large compiles in the same process.
    child = r"""
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e18)
import jax.numpy as jnp
from __graft_entry__ import _flagship_scene
from raytracer_tpu.parallel.train import train_step

scene = _flagship_scene()
n = 131072
o = jnp.zeros((n, 3), jnp.float32)
d = jnp.ones((n, 3), jnp.float32)
t = jnp.zeros((n, 3), jnp.float32)
compiled = jax.jit(
    lambda s, o, d, t: train_step(s, o, d, t, lr=1e-3)
).lower(scene, o, d, t).compile()
print("TEMP_BYTES", compiled.memory_analysis().temp_size_in_bytes)
"""
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO_ROOT)
    r = subprocess.run(
        [sys.executable, "-c", child],
        capture_output=True, timeout=900, env=env, cwd=REPO_ROOT,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    temp = int(r.stdout.split(b"TEMP_BYTES")[1].split()[0])
    temp_gb = temp / 1e9
    assert temp_gb < 12.0, f"grad temp memory regressed: {temp_gb:.2f} GB"


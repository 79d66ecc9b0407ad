"""The GPU mesh kernel (ops/mesh_kernel.py) against its reference, the
chunked scan of core/intersect.py.

On the CPU the kernel runs through the Pallas interpreter; the compiled
kernel is checked on the card by chip_smoke.py (and by the ``gpu`` test
below, which skips without a card). ``kernel_path`` makes intersect take
its GPU branch on the CPU, so the wrapper code around the kernel (padding,
gid mapping, hit recomputation) is what these tests exercise.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.core import intersect as I
from raytracer_tpu.ops import mesh_kernel as MK
from raytracer_tpu.scene import specs as S
from raytracer_tpu.scene.builder import build_scene


@pytest.fixture
def kernel_path(monkeypatch):
    """Route intersect's platform choice to the kernel, interpreted."""
    monkeypatch.setattr(
        MK, "mesh_nearest",
        functools.partial(MK.mesh_nearest, interpret=True))
    monkeypatch.setattr(I, "_by_platform", lambda gpu, default: gpu())
    yield
    jax.clear_caches()   # drop traces made under the patch


def _cloud(nt, seed, spread=3.0, size=0.5):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-spread, spread, (nt, 1, 3))
    return (c + rng.normal(0, size, (nt, 3, 3))).astype(np.float32)


def _mesh_scene(p, *extra):
    nt = p.shape[0]
    mesh = S.Mesh(p=p, n=np.zeros((nt, 3, 3), np.float32),
                  smooth=np.zeros(nt, bool))
    return build_scene([mesh, S.PointLight(position=(0, 50, 0)), *extra])


def _rays(r, seed, z=-8.0, spread=1.0, jitter=1.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-spread, spread, (r, 3)) + np.array([0, 0, z])
    d = rng.normal(0, jitter, (r, 3)) + np.array([0, 0, 3.0])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)


def _both(scene, o, d, t_cap=None):
    scan = I._tri_free_nearest_scan(scene, o, d, t_cap)
    gpu = I._tri_free_nearest_gpu(scene, o, d, t_cap)
    return [np.asarray(x) for x in scan], [np.asarray(x) for x in gpu]


def _assert_same_hits(scan, gpu, rtol=1e-5):
    (ts, gs, us, vs), (tk, gk, uk, vk) = scan, gpu
    hit = np.isfinite(ts)
    assert (np.isfinite(tk) == hit).all()            # misses agree exactly
    np.testing.assert_allclose(tk[hit], ts[hit], rtol=rtol)
    # indices agree wherever the two t are not a near-tie
    differ = hit & (gk != gs)
    np.testing.assert_allclose(tk[differ], ts[differ], rtol=1e-5)
    same = hit & (gk == gs)
    np.testing.assert_allclose(uk[same], us[same], atol=1e-4)
    np.testing.assert_allclose(vk[same], vs[same], atol=1e-4)
    return hit


@pytest.mark.parametrize("nt, r", [
    (70, 64),      # one partial chunk, one ray block
    (700, 200),    # three chunks, R not a multiple of BR
    (1500, 130),   # six chunks
])
def test_kernel_matches_scan(kernel_path, nt, r):
    scene = _mesh_scene(_cloud(nt, seed=nt))
    o, d = _rays(r, seed=r)
    scan, gpu = _both(scene, o, d)
    hit = _assert_same_hits(scan, gpu)
    assert hit.sum() > r // 5


@pytest.mark.parametrize("mode", ["below", "above", "mixed"])
def test_kernel_t_cap(kernel_path, mode):
    scene = _mesh_scene(_cloud(700, seed=5))
    o, d = _rays(256, seed=6)
    t_free = np.asarray(I._tri_free_nearest_scan(scene, o, d)[0])
    base = np.where(np.isfinite(t_free), t_free, 10.0)
    scale = {"below": 0.5, "above": 2.0,
             "mixed": np.where(np.arange(256) % 2, 0.5, 2.0)}[mode]
    cap = jnp.asarray(base * scale, jnp.float32)
    scan, gpu = _both(scene, o, d, cap)
    _assert_same_hits(scan, gpu)
    kept = t_free < np.asarray(cap)
    assert (np.isfinite(gpu[0]) == kept).all()


@pytest.mark.parametrize("capped", [False, True])
def test_kernel_any_hit(kernel_path, capped):
    """any_hit reports SOME hit below the cap for exactly the rays that
    have one, including across the early exit of fully-found blocks."""
    scene = _mesh_scene(_cloud(1500, seed=8))
    o, d = _rays(300, seed=9)
    t_ref = np.asarray(I._tri_free_nearest_scan(scene, o, d)[0])
    cap = None
    if capped:
        cap = jnp.asarray(np.where(np.isfinite(t_ref), t_ref * 1.5, 5.0)
                          * np.where(np.arange(300) % 3, 1.0, 0.0),
                          jnp.float32)   # a third of the rays: cap 0
    t_a = np.asarray(I._tri_free_nearest_gpu(scene, o, d, cap,
                                             any_hit=True)[0])
    want = t_ref < (np.inf if cap is None else np.asarray(cap))
    assert (np.isfinite(t_a) == want).all()
    assert (t_a[want] > 0).all()
    if cap is not None:
        assert (t_a[want] < np.asarray(cap)[want]).all()


def test_kernel_per_triangle_det_eps():
    """Tiny triangles of a scaled-down instance pass their own threshold
    (planes row 9); a unit threshold rejects nearly all of them."""
    rng = np.random.default_rng(3)
    nt, s = 70, 0.004
    p1 = rng.uniform(-0.02, 0.02, (nt, 3)).astype(np.float32)
    e1 = rng.normal(0, s, (nt, 3)).astype(np.float32)
    e2 = rng.normal(0, s, (nt, 3)).astype(np.float32)
    o = jnp.asarray(rng.uniform(-0.01, 0.01, (64, 3)) + [0, 0, -1.0],
                    jnp.float32)
    d = jnp.asarray(np.tile([0.0, 0.0, 1.0], (64, 1)), jnp.float32)

    def run(deps):
        planes, bb = MK.pack_planes(p1, e1, e2, deps)
        t, _ = MK.mesh_nearest(o, d, jnp.asarray(planes), jnp.asarray(bb),
                               interpret=True)
        ts, _, _ = I._tri_moller_trumbore(
            o, d, jnp.asarray(p1), jnp.asarray(e1), jnp.asarray(e2),
            det_eps=jnp.asarray(deps))
        t_ref = np.asarray(jnp.where(ts > 0, ts, jnp.inf).min(1))
        t = np.asarray(t)
        assert (np.isfinite(t) == np.isfinite(t_ref)).all()
        hit = np.isfinite(t_ref)
        np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5)
        return hit.sum()

    n_own = run(np.full(nt, 1e-12, np.float32))
    n_unit = run(np.full(nt, 1e-4, np.float32))
    assert n_own > 10 and n_unit < n_own / 4


def test_kernel_behind_query(kernel_path):
    """The reversed-ray kernel call is the behind query: the largest
    t <= 0 entry, with rays INSIDE the cloud so both signs occur."""
    scene = _mesh_scene(_cloud(700, seed=4))
    o, d = _rays(200, seed=5, z=0.0, spread=2.0, jitter=3.0)
    bt_s, bg_s = (np.asarray(x) for x in I._tri_behind_scan(scene, o, d))
    bt_k, bg_k = (np.asarray(x) for x in I._tri_behind(scene, o, d))
    have = np.isfinite(bt_s)
    assert have.sum() > 50
    assert (np.isfinite(bt_k) == have).all()
    np.testing.assert_allclose(bt_k[have], bt_s[have], rtol=1e-5)
    differ = have & (bg_k != bg_s)
    np.testing.assert_allclose(bt_k[differ], bt_s[differ], rtol=1e-5)


def test_kernel_ties_pick_first_triangle(kernel_path):
    """Exact duplicates in different chunks: both paths keep the lowest
    index (strict < across chunks, first argmin within one)."""
    p = _cloud(300, seed=12)
    scene = _mesh_scene(np.concatenate([p, p]))
    o, d = _rays(128, seed=13)
    scan, gpu = _both(scene, o, d)
    hit = _assert_same_hits(scan, gpu)
    assert hit.sum() > 20
    assert (gpu[1][hit] == scan[1][hit]).all()


def test_wrapper_lowers_kernel_only_for_cuda():
    """One path per platform, decided at lowering: the CUDA module holds
    the Triton call and no scan; the CPU module holds the scan only."""
    scene = _mesh_scene(_cloud(300, seed=1))
    o, d = _rays(64, seed=2)
    f = jax.jit(lambda o, d: I.nearest_hit(scene, o, d))
    cuda = f.trace(o, d).lower(lowering_platforms=("cuda",)).as_text()
    cpu = f.trace(o, d).lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" in cuda and "triton" not in cpu
    assert "stablehlo.while" not in cuda and "stablehlo.while" in cpu


def test_pack_planes_layout():
    p = _cloud(300, seed=3)
    p1, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    deps = np.full(300, 2e-4, np.float32)
    planes, bb = MK.pack_planes(p1, e1, e2, deps)
    assert planes.shape == (MK.N_PLANES, 512) and bb.shape == (6, 2)
    np.testing.assert_array_equal(planes[0:3, :300], p1.T)
    np.testing.assert_array_equal(planes[6:9, :300], e2.T)
    assert (planes[9, :300] == 2e-4).all() and np.isinf(planes[9, 300:]).all()
    # the partial chunk's box covers its real triangles only
    last = p[256:].reshape(-1, 3)
    np.testing.assert_allclose(bb[:3, 1], last.min(0), rtol=1e-6)
    np.testing.assert_allclose(bb[3:, 1], last.max(0), rtol=1e-6)


def test_block_order_feeds_kernel_squares():
    """Each run of BR consecutive pixel ids is one BLOCK_SIDE square."""
    from raytracer_tpu.core.render import _block_order

    h, w = 24, 40
    order = _block_order(h, w)
    assert sorted(order) == list(range(h * w))
    for blk in order.reshape(-1, MK.BR):
        ys, xs = blk // w, blk % w
        assert ys.max() - ys.min() == MK.BLOCK_SIDE - 1
        assert xs.max() - xs.min() == MK.BLOCK_SIDE - 1


def test_scene_chunk_boxes_match_scan_chunks():
    """The build-time box table is at the scan's chunk size: 1,500 free
    triangles -> 6 boxes of TRI_CHUNK, each bounding its chunk."""
    scene = _mesh_scene(_cloud(1500, seed=21))
    bb = np.asarray(scene.mesh_bb_chunk)
    assert I.TRI_CHUNK == MK.CHUNK and bb.shape == (6, 6)
    v0 = np.asarray(scene.tri_p1)
    v = np.stack([v0, v0 + np.asarray(scene.tri_e1),
                  v0 + np.asarray(scene.tri_e2)], 1)
    for c in range(6):
        chunk = v[c * 256:(c + 1) * 256].reshape(-1, 3)
        assert (chunk.min(0) >= bb[:3, c] - 1e-5).all()
        assert (chunk.max(0) <= bb[3:, c] + 1e-5).all()


@pytest.mark.parametrize("path", ["scan", "kernel"])
def test_rays_at_second_chunk_find_every_hit(path, request):
    """Regression: free-mesh chunk boxes were stored for 1,024-triangle
    chunks and read as 256-triangle ones, so on a 1,500-triangle mesh
    rays aimed at triangles 256-511 found almost nothing. Every ray aimed
    at a triangle's centroid must hit, no farther than that centroid."""
    if path == "kernel":
        request.getfixturevalue("kernel_path")
    scene = _mesh_scene(_cloud(1500, seed=31, spread=6.0, size=0.3))
    tris = np.arange(256, 512)
    p1 = np.asarray(scene.tri_p1)[tris]
    cen = p1 + (np.asarray(scene.tri_e1)[tris]
                + np.asarray(scene.tri_e2)[tris]) / 3
    o = np.array([0.0, 0.0, -40.0], np.float32) + np.zeros_like(cen)
    d = cen - o
    dist = np.linalg.norm(d, axis=1)
    d = (d / dist[:, None]).astype(np.float32)
    has, t, _, _, _ = jax.jit(lambda o, d: I.nearest_hit(scene, o, d))(
        jnp.asarray(o), jnp.asarray(d))
    assert np.asarray(has).all()
    assert (np.asarray(t) <= dist * (1 + 1e-5)).all()


def test_kernel_gradients_match_scan(kernel_path):
    """t, u, v of the kernel's hit are recomputed in jnp: their gradients
    w.r.t. the triangle tables and the rays equal the scan's."""
    scene = _mesh_scene(_cloud(700, seed=41))
    o, d = _rays(96, seed=42)

    def loss(fn, p1, e1, e2, o, d):
        sc = dataclasses.replace(scene, tri_p1=p1, tri_e1=e1, tri_e2=e2)
        t, _, u, v = fn(sc, o, d)
        ok = jnp.isfinite(t)
        return jnp.sum(jnp.where(ok, t + 3 * u - 2 * v, 0.0))

    args = (scene.tri_p1, scene.tri_e1, scene.tri_e2, o, d)
    g_s = jax.grad(functools.partial(loss, I._tri_free_nearest_scan),
                   argnums=range(5))(*args)
    g_k = jax.grad(functools.partial(loss, I._tri_free_nearest_gpu),
                   argnums=range(5))(*args)
    assert float(jnp.abs(g_s[0]).sum()) > 0
    for a, b in zip(g_k, g_s):
        assert np.isfinite(np.asarray(a)).all()
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("transparent", [False, True])
def test_render_kernel_matches_scan(kernel_path, transparent, monkeypatch):
    """A whole frame through render(): kernel path (interpreted) against
    the scan path, opaque (nearest + any-hit shadows) and transparent
    (candidate table + behind query)."""
    from raytracer_tpu import transforms as tf
    from raytracer_tpu.camera import Camera
    from raytracer_tpu.core.render import render

    mat = S.Material(color=(0.8, 0.3, 0.2),
                     transparency=0.8 if transparent else 0.0,
                     refractive_index=1.5 if transparent else 1.0)
    p = _cloud(600, seed=51, spread=1.5, size=0.4)
    mesh = S.Mesh(p=p, n=np.zeros((600, 3, 3), np.float32),
                  smooth=np.zeros(600, bool), material=mat)
    scene = build_scene([mesh, S.Plane(transform=tf.translation(0, -2, 0)),
                         S.PointLight(position=(-10, 10, -10))],
                        recursion_limit=2)
    cam = Camera(24, 16, 1.0).with_transform(
        tf.view_transform((0, 0.5, -6), (0, 0, 0), (0, 1, 0)))
    img_k = render(scene, cam, quantize=True)
    jax.clear_caches()
    monkeypatch.setattr(I, "_by_platform", lambda gpu, default: default())
    img_s = render(scene, cam, quantize=True)
    off = np.abs(img_k.astype(int) - img_s.astype(int)).max(-1) > 1
    assert off.mean() <= 0.005
    assert img_s.max() > 50


@pytest.mark.gpu
def test_compiled_kernel_matches_scan(gpu_device):
    """The compiled Triton kernel against the scan on the card."""
    scene = _mesh_scene(_cloud(1500, seed=61))
    o, d = _rays(1000, seed=62)
    query = lambda o, d: I._tri_free_nearest(scene, o, d)
    with jax.default_device(gpu_device):
        gpu = [np.asarray(x) for x in jax.jit(query)(o, d)]
    with jax.default_device(jax.devices("cpu")[0]):
        scan = [np.asarray(x) for x in jax.jit(query)(o, d)]
    _assert_same_hits(scan, gpu)

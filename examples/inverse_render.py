"""Inverse rendering demo: recover a sphere's color — or its POSE — from
a target image.

No reference analogue — the whole renderer is one differentiable XLA
program, so scene parameters optimize by gradient descent against a
rendered target (SURVEY §7.7).

Run: python examples/inverse_render.py          (64x36 smoke, any backend)
     python examples/inverse_render.py --hd     (1280x720 on one GPU)
     python examples/inverse_render.py --pose [--hd]
         pose-recovery mode: the sphere starts at a perturbed
         translation and optax.adam descends the image MSE back to the
         true position via with_prim_transform (the world->object
         inverse and normal matrix are recomputed in-trace, so the
         gradient stays consistent with shading). The signal is the
         LOCAL shading/shadow derivative — silhouette jumps carry no
         gradient — which suffices for small pose errors like this one.

The --hd mode optimizes against a full 921,600-ray frame: per-level
rematerialization (render_loss's default) plus 8-way gradient-accumulation
microbatches (``n_micro``) keep the backward pass inside one device's
memory — the full-frame gradient without them needs several times that.
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu import Camera, transforms as tf
from raytracer_tpu.camera import ray_grid
from raytracer_tpu.scene import Material, Plane, PointLight, Sphere, build_scene
from raytracer_tpu.core.render import color_at
from raytracer_tpu.parallel.train import (
    partition_scene, render_loss_and_grad,
)


def make_scene(color):
    return build_scene([
        PointLight(position=(-10.0, 10.0, -10.0)),
        Plane(material=Material(specular=0.0)),
        Sphere(transform=tf.translation(-0.5, 1.0, 0.5),
               material=Material(color=color, diffuse=0.7)),
    ], recursion_limit=1)


hd = "--hd" in sys.argv
pose_mode = "--pose" in sys.argv
hsize, vsize = (1280, 720) if hd else (64, 36)
n_micro = 8 if hd else None
steps = 60 if hd else 120

cam = Camera(hsize, vsize, math.pi / 3).with_transform(
    tf.view_transform((0.0, 1.5, -5.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0)))
origins, directions = (jnp.asarray(a) for a in ray_grid(cam))


def pose_recovery():
    """Recover the sphere's translation from the image loss.

    COARSE-TO-FINE: the depth axis has only interior-shading gradients
    (silhouette and binary-shadow terms carry none), and descending the
    full-resolution loss directly lets z drift into a shallow
    wrong-depth valley (r5 measured: err 0.18 at 720p direct vs 2e-4
    via coarse-first) — so the pose is recovered on a 96x54 grid first,
    then polished at full resolution with a smaller step.
    """
    import optax
    from raytracer_tpu.parallel.train import with_prim_transform

    scene = make_scene((0.9, 0.1, 0.1))
    gid = scene.static.family_range("sphere")[0]
    true_t = jnp.asarray([-0.5, 1.0, 0.5])

    def make_stage(stage_cam, rays, micro, target):
        s_o, s_d = rays

        def loss_fn(t3):
            m = jnp.eye(4).at[:3, 3].set(t3)
            sc = with_prim_transform(scene, gid, m)
            if micro:
                # gradient accumulation over ray chunks (720p memory)
                o = s_o.reshape(micro, -1, 3)
                d = s_d.reshape(micro, -1, 3)
                tg = target.reshape(micro, -1, 3)

                def body(acc, xs):
                    o_, d_, t_ = xs
                    img = color_at(sc, o_, d_)
                    return acc + jnp.mean((img - t_) ** 2), None

                total, _ = jax.lax.scan(body, jnp.zeros(()), (o, d, tg))
                return total / micro
            img = color_at(sc, s_o, s_d)
            return jnp.mean((img - target) ** 2)

        return jax.jit(jax.value_and_grad(loss_fn))

    def descend(vg, t3, lr, n_steps, tag, every):
        opt = optax.adam(lr)
        opt_state = opt.init(t3)
        losses = []
        for step in range(n_steps):
            loss, g = vg(t3)
            losses.append(float(loss))
            updates, opt_state = opt.update(g, opt_state, t3)
            t3 = optax.apply_updates(t3, updates)
            if step % every == 0:
                err = float(jnp.linalg.norm(t3 - true_t))
                print(f"{tag} step {step:3d}  loss {float(loss):.6f}  "
                      f"pos {np.asarray(t3).round(3)}  err {err:.4f}")
        return t3, losses

    # --- coarse stage: 96x54 ---------------------------------------------
    c_cam = Camera(96, 54, math.pi / 3).with_transform(
        tf.view_transform((0.0, 1.5, -5.0), (0.0, 1.0, 0.0), (0.0, 1.0, 0.0)))
    c_rays = tuple(jnp.asarray(a) for a in ray_grid(c_cam))
    c_target = color_at(scene, *c_rays)
    vg_c = make_stage(c_cam, c_rays, None, c_target)

    t3 = true_t + jnp.asarray([0.2, -0.12, 0.1])   # perturbed start
    t3, losses = descend(vg_c, t3, 2e-2, 200, "coarse", 25)

    # --- fine stage (HD): polish at full resolution ----------------------
    # Tiny lr: adam's update magnitude is ~lr regardless of gradient
    # scale, so polishing FROM the coarse optimum with lr 3e-3 x 50
    # random-walked ~0.07 away (r5 measured); 3e-4 x 30 bounds the
    # worst-case wander at ~0.009 while still correcting real residue.
    if hd:
        from raytracer_tpu.core.render import render
        f_target = jnp.asarray(render(scene, cam).reshape(-1, 3))
        vg_f = make_stage(cam, (origins, directions), n_micro, f_target)
        t3, f_losses = descend(vg_f, t3, 3e-4, 30, "fine", 8)
        losses += f_losses

    err = float(jnp.linalg.norm(t3 - true_t))
    res = f"{cam.hsize}x{cam.vsize}" if hd else "96x54"
    print(f"recovered translation: {np.asarray(t3).round(4)}  "
          f"(truth {np.asarray(true_t)})  error {err:.4f}")
    assert err < 0.05, err
    assert losses[-1] < losses[0] * 0.1, (losses[0], losses[-1])
    # the loss curve trends down (adam wiggles; compare window means)
    third = len(losses) // 3
    assert np.mean(losses[-third:]) < np.mean(losses[:third])
    print(f"OK pose ({res}; loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f} over {len(losses)} steps)")


if pose_mode:
    pose_recovery()
    sys.exit(0)

# ground truth: a red sphere. The target frame renders tile-by-tile (the
# production forward path) so even the 720p target needs no special care.
truth = make_scene((0.9, 0.1, 0.1))
if hd:
    from raytracer_tpu.core.render import render
    target = jnp.asarray(render(truth, cam).reshape(-1, 3))
else:
    target = color_at(truth, origins, directions)

# start from a blue guess and descend
guess = make_scene((0.1, 0.2, 0.8))
params, recombine = partition_scene(guess)
value_and_grad = jax.jit(lambda p: render_loss_and_grad(
    p, recombine, origins, directions, target, n_micro=n_micro))

lr = 2.0
losses = []
for step in range(steps):
    loss, grads = value_and_grad(params)
    losses.append(float(loss))
    # optimize just the unknown (the sphere color) — everything else of
    # the scene is known here; full-scene optimization works the same way
    # with a per-parameter optimizer (optax) instead of plain SGD
    params["mat"] = params["mat"].at[0, :3].add(-lr * grads["mat"][0, :3])
    if step % (4 if hd else 20) == 0:
        print(f"step {step:3d}  loss {float(loss):.6f}  "
              f"sphere color {np.asarray(params['mat'][0, :3]).round(3)}")

final = np.asarray(params["mat"][0, :3])
print(f"recovered color: {final.round(3)}  (truth: [0.9 0.1 0.1])")
head = losses[:21]
assert all(b < a for a, b in zip(head, head[1:])), (
    "loss not strictly decreasing over the first 20 steps")
assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])
tol = 0.1 if hd else 0.05
assert np.allclose(final, [0.9, 0.1, 0.1], atol=tol), final
print(f"OK ({hsize}x{vsize}; loss {losses[0]:.5f} -> {losses[-1]:.5f} "
      f"over {len(losses)} steps)")

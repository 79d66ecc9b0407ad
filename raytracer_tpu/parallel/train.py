"""Differentiable rendering: loss + sharded training step.

New capability vs the reference (which is forward-only): the whole render is
one differentiable JAX program, so scene parameters (material tables, light
intensities, pattern colors, transforms...) can be optimized against a
target image. Under a sharded ray axis each device takes the gradient of
its own rays and one ``pmean`` (all-reduce) averages them — the canonical
data-parallel training layout.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from raytracer_tpu.core import types as T
from raytracer_tpu.core.render import color_at


# Float tables that are DERIVED from (or coupled to) other tables at scene
# build time: inv_tf pairs with normal_mat, the triangle vertex/edge tables
# pair with their precomputed world-space normals, pat_inv is the inverse of
# the pattern transform, and alight_pos is computed from corner/uvec/vvec.
# Optimizing one of these without recomputing its partners silently desyncs
# geometry from its shading normals, so they are excluded from the default
# grad surface (opt in with include_geometry=True and keep them consistent
# yourself, e.g. by reparameterizing on the source transform).
DERIVED_GEOMETRY = frozenset({
    "inv_tf", "normal_mat",
    "tri_p1", "tri_e1", "tri_e2",
    "tri_shade", "tri_det_eps",
    "pat_inv",
    "alight_corner", "alight_uvec", "alight_vvec", "alight_pos",
    # packed copies of the triangle tables (builder.finish)
    "mesh_planes", "mesh_bb_chunk",
})


def partition_scene(scene: T.Scene, *, include_geometry: bool = False):
    """Split the scene into (diff_params, recombine_fn).

    ``diff_params`` is a dict of float-dtype array fields — the grad-able
    surface: materials, light intensities/positions, pattern colors, images.
    Integer/bool tables (ids, flags) stay static, and so do the
    :data:`DERIVED_GEOMETRY` tables unless ``include_geometry`` is set.
    """
    params, rest = {}, {}
    for f in dataclasses.fields(scene):
        if f.name == "static":
            continue
        val = getattr(scene, f.name)
        is_float = hasattr(val, "dtype") and jnp.issubdtype(val.dtype, jnp.floating)
        if is_float and (include_geometry or f.name not in DERIVED_GEOMETRY):
            params[f.name] = val
        else:
            rest[f.name] = val

    def recombine(p):
        return T.Scene(**p, **rest, static=scene.static)

    return params, recombine


def render_loss(params, recombine, origins, directions, target, key=None,
                *, remat=True):
    """Mean-squared error between the rendered ray colors and ``target``.

    ``remat=True`` (default) recomputes each bounce level in the backward
    pass instead of storing its residuals (see ``color_at``): a blend
    scene's deepest level is 16x the ray batch wide, and without remat
    its residuals dominate the gradient's memory.
    """
    scene = recombine(params)
    img = color_at(scene, origins, directions, key, remat=remat)
    return jnp.mean((img - target) ** 2)


def _grad_microbatched(params, recombine, origins, directions, target, key,
                       n_micro, remat=True):
    """value_and_grad of :func:`render_loss`, accumulated over ``n_micro``
    sequential microbatches of the ray axis (a lax.scan), so grad memory
    is bounded by one microbatch regardless of total batch size. Exact:
    MSE over equal-size chunks averages to the full-batch MSE, and grads
    are linear in the loss.
    """
    n = origins.shape[0]
    if n % n_micro:
        raise ValueError(f"batch {n} not divisible by {n_micro} microbatches")
    m = n // n_micro
    o = origins.reshape(n_micro, m, 3)
    d = directions.reshape(n_micro, m, 3)
    t = target.reshape(n_micro, m, 3)
    keys = (
        jax.random.split(key, n_micro)
        if key is not None
        else jnp.zeros((n_micro, 0), jnp.uint32)
    )

    def body(carry, xs):
        loss_sum, grad_sum = carry
        o_, d_, t_, k_ = xs
        k_ = k_ if key is not None else None
        loss, grads = jax.value_and_grad(render_loss)(
            params, recombine, o_, d_, t_, k_, remat=remat
        )
        grad_sum = jax.tree.map(jnp.add, grad_sum, grads)
        return (loss_sum + loss, grad_sum), None

    zero_grads = jax.tree.map(jnp.zeros_like, params)
    (loss_sum, grad_sum), _ = jax.lax.scan(
        body, (jnp.zeros(()), zero_grads), (o, d, t, keys)
    )
    scale = 1.0 / n_micro
    return loss_sum * scale, jax.tree.map(lambda g: g * scale, grad_sum)


def render_loss_and_grad(params, recombine, origins, directions, target,
                         key=None, *, n_micro=None, remat=True):
    """(loss, grads) of :func:`render_loss` w.r.t. ``params`` — the public
    entry for custom optimization loops. ``n_micro`` accumulates gradients
    over that many sequential ray microbatches (exact; bounds memory by
    one microbatch — how a 1280x720 frame's gradient fits on one device).

    ``remat``: per-bounce-level rematerialization (see render_loss), a
    memory-vs-speed knob: once microbatching narrows the 16R-wide deep
    levels, storing residuals can beat recomputing the trace. Which
    setting is faster on the GPU is still to be measured; keep the
    default for single-shot full-batch gradients."""
    if n_micro is not None and n_micro > 1:
        return _grad_microbatched(
            params, recombine, origins, directions, target, key, n_micro,
            remat=remat,
        )
    return jax.value_and_grad(render_loss)(
        params, recombine, origins, directions, target, key, remat=remat
    )


def train_step(scene: T.Scene, origins, directions, target, *, lr=1e-2,
               key=None, n_micro=None, remat=True):
    """One SGD step on all float scene parameters. Returns (loss, scene').

    ``n_micro``: split the ray batch into that many sequential microbatches
    with gradient accumulation (exact, bounds grad memory by one
    microbatch). None = single full-batch gradient (per-level remat still
    bounds it by the widest bounce level — see :func:`render_loss`).
    ``remat``: see :func:`render_loss_and_grad` for the speed/memory
    tradeoff.
    """
    params, recombine = partition_scene(scene)
    loss, grads = render_loss_and_grad(
        params, recombine, origins, directions, target, key, n_micro=n_micro,
        remat=remat,
    )
    new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
    return loss, recombine(new_params)


def make_optax_step(optimizer, *, param_filter=None):
    """A jitted optax training step over the scene's float tables.

    ``optimizer`` is any optax GradientTransformation (adam, sgd, ...).
    ``param_filter``: optional predicate ``name -> bool`` choosing which
    scene tables to optimize (others stay frozen). Returns
    ``(init_fn(scene) -> opt_state, step_fn(scene, opt_state, o, d,
    target, key) -> (loss, scene', opt_state'))``.
    """
    import optax  # baked into the image; imported lazily

    def split(scene):
        params, recombine = partition_scene(scene)
        if param_filter is None:
            return params, {}, recombine
        train = {k: v for k, v in params.items() if param_filter(k)}
        frozen = {k: v for k, v in params.items() if not param_filter(k)}
        return train, frozen, recombine

    def init_fn(scene):
        train, _, _ = split(scene)
        return optimizer.init(train)

    @jax.jit
    def step_fn(scene, opt_state, origins, directions, target, key=None):
        train, frozen, recombine = split(scene)

        def loss_fn(p):
            return render_loss({**p, **frozen}, recombine, origins,
                               directions, target, key)

        loss, grads = jax.value_and_grad(loss_fn)(train)
        updates, opt_state = optimizer.update(grads, opt_state, train)
        train = optax.apply_updates(train, updates)
        return loss, recombine({**train, **frozen}), opt_state

    return init_fn, step_fn


def make_sharded_train_step(mesh: Mesh, *, lr=1e-2, n_micro=None,
                            remat=True):
    """A jitted train step with rays/targets sharded and params replicated.

    The returned fn has signature ``(scene, origins, directions, target,
    key) -> (loss, scene')``. Each device takes the loss and gradient of
    its own rays under ``shard_map`` (the mesh kernel is a Pallas call,
    which GSPMD cannot partition), and one ``pmean`` over every mesh axis
    averages both — exact for equal shard sizes, which shard_rays
    guarantees. Works for the 1-D device mesh and the 2-D
    :func:`make_host_mesh` host x device mesh alike.

    ``n_micro``: sequential gradient-accumulation microbatches per device
    (each device scans its own shard); bounds per-device grad memory like
    :func:`train_step`. ``remat``: see :func:`render_loss_and_grad`.
    """
    axes = mesh.axis_names
    rays = P(axes)

    def local_step(scene, origins, directions, target, key):
        params, recombine = partition_scene(scene)
        loss, grads = render_loss_and_grad(
            params, recombine, origins, directions, target, key,
            n_micro=n_micro, remat=remat,
        )
        loss, grads = jax.lax.pmean((loss, grads), axes)
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return loss, recombine(new_params)

    # check_vma=False: Pallas results carry no varying-axis types, and
    # with the checks on the per-level remat program crashed XLA:CPU's
    # runtime on four or more devices
    return jax.jit(jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), rays, rays, rays, P()),
        out_specs=(P(), P()), check_vma=False,
    ))


def with_prim_transform(scene: T.Scene, gid: int, matrix):
    """Scene with primitive ``gid``'s world transform replaced,
    DIFFERENTIABLY: the world->object inverse and the normal matrix are
    recomputed from ``matrix`` inside the trace, so ``jax.grad`` w.r.t.
    the 4x4 (or a pose parameterization producing it) stays consistent —
    the raw-table alternative desyncs inv_tf from normal_mat (see
    DERIVED_GEOMETRY).

    Non-triangle primitives only (a mesh's vertices are pre-transformed
    to world space at build; reposing a mesh needs a scene rebuild).
    ``gid`` is the primitive's global id — for a single-shape family use
    ``sum(static.counts[:family_index]) + index_in_family``.
    """
    g_nt = sum(scene.static.counts[:5])
    if not 0 <= gid < g_nt:
        raise ValueError(
            f"gid {gid} is not a non-triangle primitive (0..{g_nt - 1})"
        )
    matrix = jnp.asarray(matrix, jnp.float32)
    inv = jnp.linalg.inv(matrix)
    nm = jnp.transpose(inv)[:3, :3]
    return dataclasses.replace(
        scene,
        inv_tf=scene.inv_tf.at[gid].set(inv),
        normal_mat=scene.normal_mat.at[gid].set(nm),
    )

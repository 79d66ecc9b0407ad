"""Multi-device execution: shard the pixel/ray grid over a device mesh.

The reference's only parallelism is rayon work-stealing over pixels on one
shared-memory machine (camera.rs:66-84). Here rays are embarrassingly
parallel, so the ray axis is sharded over a 1-D ``jax.sharding.Mesh`` while
the scene SoA tables are replicated: the forward render needs no
collectives (pure data parallel) and the training step one ``pmean``
(all-reduce) of the scene-parameter gradients.
"""

from raytracer_tpu.parallel.mesh import (
    make_mesh,
    render_sharded,
    shard_rays,
    replicate_scene,
)
from raytracer_tpu.parallel.train import train_step, render_loss

__all__ = [
    "make_mesh",
    "render_sharded",
    "shard_rays",
    "replicate_scene",
    "train_step",
    "render_loss",
]

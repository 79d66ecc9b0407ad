"""Per-tile checkpoint/resume for long renders.

The reference is one-shot (SURVEY §5: no checkpointing; a crashed
45-minute dragons render restarts from zero). The pixel-tile grid is
embarrassingly restartable: each finished tile is flushed to a .npy
memmap next to a bitmap of completed tiles, so re-invoking the same
render continues from the first missing tile.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from raytracer_tpu.core.render import (
    _block_order, _tile_color_jit, camera_consts,
)
from raytracer_tpu.utils.profiling import RenderStats


def _render_digest(scene, key) -> str:
    """Digest of everything that determines tile contents: every scene
    table, the static facts (incl. recursion limit and jitter mode) and
    the PRNG key. A checkpoint made for a different scene/key must not be
    resumed — it would silently mix stale tiles into the output."""
    h = hashlib.sha256()
    for f in dataclasses.fields(scene):
        val = getattr(scene, f.name)
        h.update(f.name.encode())
        if f.name == "static":
            h.update(repr(val).encode())
        else:
            a = np.asarray(val)
            h.update(str(a.dtype).encode() + str(a.shape).encode())
            h.update(a.tobytes())
    h.update(np.asarray(key).tobytes())
    return h.hexdigest()


def render_resumable(scene, camera, checkpoint_path, *, key=None,
                     tile_rays=1 << 14, stats: RenderStats | None = None,
                     max_retries: int = 2, on_retry=None):
    """Like core.render.render but flushing each tile to disk.

    ``checkpoint_path`` is a directory; re-running with the same path and
    shape resumes after the last complete tile. Returns the full image.

    Failure detection (SURVEY §5: the reference has none — a crashed
    45-minute dragons render restarts from zero): every tile is validated
    before being marked done — a non-finite tile (device fault, transport
    corruption) or a raised device error is retried up to ``max_retries``
    times; a tile that keeps failing raises RuntimeError with every other
    finished tile already flushed, so the re-run retries ONLY the bad
    tile. ``on_retry(tile_index, attempt, reason)`` observes retries
    (tests / logging).
    """
    ckpt = Path(checkpoint_path)
    ckpt.mkdir(parents=True, exist_ok=True)
    meta_p = ckpt / "meta.json"
    img_p = ckpt / "image.npy"
    done_p = ckpt / "done.npy"

    if key is None:
        key = jax.random.PRNGKey(0)
    scene = jax.device_put(scene)
    n = camera.vsize * camera.hsize
    tile = min(tile_rays, n)
    n_tiles = -(-n // tile)

    meta = dict(h=camera.vsize, w=camera.hsize, tile=tile,
                digest=_render_digest(scene, key))
    if meta_p.exists() and json.loads(meta_p.read_text()) == meta \
            and img_p.exists() and done_p.exists():
        flat = np.lib.format.open_memmap(img_p, mode="r+")
        done = np.lib.format.open_memmap(done_p, mode="r+")
    else:
        flat = np.lib.format.open_memmap(
            img_p, mode="w+", dtype=np.float32, shape=(n, 3))
        done = np.lib.format.open_memmap(
            done_p, mode="w+", dtype=bool, shape=(n_tiles,))
        done[:] = False
        meta_p.write_text(json.dumps(meta))

    order = _block_order(camera.vsize, camera.hsize)
    n_pad = -n % tile
    padded = np.pad(order, (0, n_pad)) if n_pad else order
    inv, consts = camera_consts(camera)

    for ti in range(n_tiles):
        if done[ti]:
            continue
        if stats is not None:
            stats.start_tile()
        i = ti * tile
        tkey = jax.random.fold_in(key, i)
        part = None
        for attempt in range(max_retries + 1):
            try:
                part = np.asarray(_tile_color_jit(
                    scene, inv, consts,
                    jnp.asarray(padded[i : i + tile], jnp.int32), tkey,
                    scene.static.recursion_limit, camera.hsize,
                ))
            except Exception as e:  # transient device/transport error
                reason = f"{type(e).__name__}: {e}"
                part = None
            else:
                if np.isfinite(part).all():
                    break
                reason = "non-finite tile output"
                part = None
            if attempt == max_retries:
                raise RuntimeError(
                    f"tile {ti} failed after {max_retries + 1} attempts "
                    f"({reason}); finished tiles are checkpointed — "
                    f"re-run to retry only this tile"
                )
            if on_retry is not None:
                on_retry(ti, attempt, reason)
        sel = order[i : min(i + tile, n)]
        flat[sel] = part[: len(sel)]
        done[ti] = True
        flat.flush(); done.flush()
        if stats is not None:
            stats.end_tile(len(sel))

    return np.asarray(flat).reshape(camera.vsize, camera.hsize, 3).copy()

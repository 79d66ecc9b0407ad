"""A seeded, smooth, closed stand-in for teapot.obj.

The benchmark scenes instance teapot.obj (6,320 triangles after the
reference's fan triangulation), an asset these machines do not have. This
module generates a mesh with the same triangle count and the same extents
(x [-15, 17.17], y [-10, 10], z [0, 15.75], z-up; gen_dragons_equiv.py's
TEAPOT_SPAN), so benchmarks/dragons_equiv.yaml's placements fill the same
boxes: a sphere whose radius carries a few random low-order harmonics,
cut into ``n_lon`` x ``n_lat`` bands with fan caps at both poles, with
area-weighted vertex normals.

    python benchmarks/gen_mesh.py OUT.obj [--seed N]
"""

from __future__ import annotations

import argparse

import numpy as np

# teapot.obj's bounding box (z-up): see gen_dragons_equiv.TEAPOT_SPAN
LO = np.array([-15.0, -10.0, 0.0])
HI = np.array([17.17, 10.0, 15.75])
N_LON, N_LAT = 79, 41          # 2 * 79 * (41 - 1) = 6,320 triangles


def mesh(seed: int = 0, n_lon: int = N_LON, n_lat: int = N_LAT):
    """(vertices [V, 3], normals [V, 3], faces [F, 3] 0-based);
    F = 2 * n_lon * (n_lat - 1)."""
    rng = np.random.default_rng(seed)
    theta = np.linspace(0.0, np.pi, n_lat + 1)[1:-1]          # ring polar
    phi = np.linspace(0.0, 2 * np.pi, n_lon, endpoint=False)
    th, ph = np.meshgrid(theta, phi, indexing="ij")           # [n_lat-1, n_lon]
    dirs = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                     np.cos(th)], -1).reshape(-1, 3)
    dirs = np.concatenate([dirs, [[0, 0, 1.0], [0, 0, -1.0]]])

    # smooth radius: 1 + small random harmonics in (theta, phi)
    t = np.arccos(np.clip(dirs[:, 2], -1, 1))
    p = np.arctan2(dirs[:, 1], dirs[:, 0])
    radius = np.ones(len(dirs))
    for k in range(1, 4):
        a, b, c = rng.uniform(-0.08, 0.08, 3) / k
        radius += a * np.cos(k * t) + b * np.sin(t) * np.cos(k * p + c * 10)
    verts = dirs * radius[:, None]
    verts = LO + (verts - verts.min(0)) / np.ptp(verts, 0) * (HI - LO)

    rings, top, bottom = n_lat - 1, len(dirs) - 2, len(dirs) - 1
    idx = np.arange(rings * n_lon).reshape(rings, n_lon)
    nxt = np.roll(idx, -1, axis=1)
    a, b = idx[:-1].ravel(), nxt[:-1].ravel()
    c, d = idx[1:].ravel(), nxt[1:].ravel()
    faces = np.concatenate([
        np.stack([a, c, b], 1), np.stack([b, c, d], 1),       # bands
        np.stack([np.full(n_lon, top), idx[0], nxt[0]], 1),   # north cap
        np.stack([np.full(n_lon, bottom), nxt[-1], idx[-1]], 1),
    ])

    v = verts[faces]
    fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])      # area-weighted
    normals = np.zeros_like(verts)
    for k in range(3):
        np.add.at(normals, faces[:, k], fn)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return verts, normals, faces


def obj_text(seed: int = 0, n_lon: int = N_LON, n_lat: int = N_LAT) -> str:
    """The mesh as OBJ source with ``v``, ``vn`` and ``f v//vn`` lines."""
    verts, normals, faces = mesh(seed, n_lon, n_lat)
    lines = [f"# seeded teapot.obj stand-in, seed {seed}"]
    lines += [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"vn {x:.6f} {y:.6f} {z:.6f}" for x, y, z in normals]
    lines += [f"f {a}//{a} {b}//{b} {c}//{c}" for a, b, c in faces + 1]
    return "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    with open(args.out, "w") as f:
        f.write(obj_text(args.seed))


if __name__ == "__main__":
    main()

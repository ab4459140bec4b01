"""A subdivided icosahedron: 20 * 4**subdivisions triangles, unit radius,
smooth vertex normals, three lights, the camera 3 units up the z axis.

Copied from distributed_raytracer_tpu_torch/utils/scenes.py:22-27 (the
icosahedron's faces), :85-130 (`icosphere_mesh`) and :133-141
(`icosphere_scene`), the logic unchanged, so the benchmark makes its own
triangles. Parameters: {"subdivisions": int, "lights": int (3)}. Meshes of
six or more subdivisions are cached in `cache_dir` as .npz files (a fixed
name per subdivision count): the 9-subdivision mesh takes seconds to make.
"""

from __future__ import annotations

import os

import numpy as np

from rtbench.scenes import Mesh, SceneSpec

_ICO_FACES = [
    (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
    (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
    (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
    (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
]
MATERIAL = ((0.05, 0.05, 0.05), (0.7, 0.7, 0.75), (0.4, 0.4, 0.4), 20.0)
LIGHT_POS = np.array([[5.0, 5.0, 5.0], [-5.0, 5.0, 5.0], [0.0, -5.0, 5.0]])
LIGHT_COL = np.array([[1.0, 1.0, 1.0], [1.0, 0.3, 0.3], [0.3, 0.3, 1.0]])
CACHE_FROM = 6


def _subdivide(subdivisions: int):
    """(vertices (V, 3) float64 on the unit sphere, faces (F, 3) int64)."""
    phi = (1 + 5 ** 0.5) / 2
    verts = np.array([
        (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
        (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
        (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(_ICO_FACES, dtype=np.int64)
    for _ in range(subdivisions):
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        edges = np.concatenate([
            np.stack([a, b], axis=1), np.stack([b, c], axis=1),
            np.stack([c, a], axis=1)])
        edges.sort(axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        mids = (verts[uniq[:, 0]] + verts[uniq[:, 1]]) / 2.0
        mids /= np.linalg.norm(mids, axis=1, keepdims=True)
        base = len(verts)
        verts = np.concatenate([verts, mids])
        n_f = len(faces)
        ab = base + inv[:n_f]
        bc = base + inv[n_f:2 * n_f]
        ca = base + inv[2 * n_f:]
        faces = np.concatenate([
            np.stack([a, ab, ca], axis=1), np.stack([b, bc, ab], axis=1),
            np.stack([c, ca, bc], axis=1), np.stack([ab, bc, ca], axis=1),
        ]).astype(np.int64)
    return verts, faces


def mesh(subdivisions: int, cache_dir: str) -> Mesh:
    path = os.path.join(cache_dir, f"icosphere-{subdivisions}.npz")
    if subdivisions >= CACHE_FROM and os.path.exists(path):
        with np.load(path) as z:
            verts, faces = z["vertices"], z["faces"]
    else:
        verts, faces = _subdivide(subdivisions)
        faces = faces.astype(np.int32)
        if subdivisions >= CACHE_FROM:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp.npz"
            np.savez(tmp, vertices=verts, faces=faces)
            os.replace(tmp, path)
    return Mesh(vertices=verts, normals=verts.copy(), faces=faces,
                material=MATERIAL)


def make(params: dict, cache_dir: str) -> SceneSpec:
    n_lights = int(params.get("lights", 3))
    return SceneSpec(
        meshes={"ico": mesh(int(params["subdivisions"]), cache_dir)},
        instances=[("ico", np.zeros(3))],
        light_pos=LIGHT_POS[:n_lights].copy(),
        light_col=LIGHT_COL[:n_lights].copy(),
        cam_pos=np.array([0.0, 0.0, 3.0]),
        cam_dir=np.array([0.0, 0.0, -1.0]), fov=1.04719755)

"""Procedural and derived benchmark scenes (BASELINE.json configs 1-5).

The reference's benchmark mesh (Stanford bunny, 4,968 faces) is not shipped;
these functions produce the required scales instead:
  - example_scene: a procedural icosahedron (config 1)
  - instanced_grid: N x N copies of a base scene's first mesh (config 3:
    64x Suzanne ~= 62K tris, forcing a real acceleration structure)
  - icosphere: subdivided icosahedron at any power-of-4 triangle count
    (config 4: bunny-class 100-300K tris; config 5: multi-million)
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.objparse import Material, MeshData
from distributed_raytracer_tpu_torch.models.scene import (Scene, SceneObject,
                                                          load_scene)

_ICO_FACES = [
    (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
    (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
    (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
    (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
]


def example_scene() -> Scene:
    """A 20-triangle icosahedron at the origin, one white light, the
    camera 6 units up the z axis (the procedural scene of the JAX
    package's entry point, __graft_entry__._example_scene, loaded through
    this package's load_scene). It reads nothing outside the package: a
    scene from elsewhere is loaded with models.scene.load_scene(path)."""
    phi = (1 + 5 ** 0.5) / 2
    verts = []
    for a, b in [(1, phi), (-1, phi), (1, -phi), (-1, -phi)]:
        verts += [(0, a, b), (a, b, 0), (b, 0, a)]
    scene = {
        "objs": [{"model": "ico.obj", "pos": {"x": 0.0, "y": 0.0, "z": 0.0}}],
        "lights": [{"pos": {"x": 5.0, "y": 5.0, "z": 5.0},
                    "col": {"r": 255, "g": 255, "b": 255}}],
        "cam": {"pos": {"x": 0.0, "y": 0.0, "z": 6.0},
                "dir": {"x": 0.0, "y": 0.0, "z": -1.0}, "fov": 1.04719755},
    }
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "ico.obj"), "w") as f:
            for v in verts:
                f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for a, b, c in _ICO_FACES:
                f.write(f"f {a + 1} {b + 1} {c + 1}\n")
        with open(os.path.join(d, "scene.json"), "w") as f:
            json.dump(scene, f)
        return load_scene(os.path.join(d, "scene.json"))


def instanced_grid(base: Scene, n: int, spacing: float = 3.0) -> Scene:
    """n x n grid of the base scene's first object's mesh."""
    first = base.objects[0]
    objects = []
    k = 0
    for gy in range(n):
        for gx in range(n):
            offset = np.array([
                (gx - (n - 1) / 2.0) * spacing,
                (gy - (n - 1) / 2.0) * spacing,
                0.0,
            ])
            k += 1
            objects.append(SceneObject(obj_id=k, model=first.model,
                                       pos=first.pos + offset))
    # Pull the camera back to frame the grid.
    cam = base.camera
    back = cam.pos - cam.forward * (spacing * n * 0.8)
    camera = Camera.create(back, cam.forward, cam.fov)
    return Scene(meshes=dict(base.meshes), objects=objects,
                 light_pos=base.light_pos.copy(), light_col=base.light_col.copy(),
                 camera=camera)


def icosphere_mesh(subdivisions: int, material: Material | None = None) -> MeshData:
    """Subdivided icosahedron: 20 * 4^subdivisions triangles, unit radius,
    smooth vertex normals (= vertex positions on a unit sphere)."""
    phi = (1 + 5 ** 0.5) / 2
    verts = np.array([
        (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
        (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
        (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
    ], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(_ICO_FACES, dtype=np.int64)

    for _ in range(subdivisions):
        # Vectorized 1->4 subdivision (multi-million-triangle scenes for
        # BASELINE config 5 need this; a per-edge dict loop takes minutes
        # at 4^8+ faces). Midpoints dedup via np.unique on sorted edge keys.
        a, b, c = faces[:, 0], faces[:, 1], faces[:, 2]
        edges = np.concatenate([
            np.stack([a, b], axis=1), np.stack([b, c], axis=1),
            np.stack([c, a], axis=1)])
        edges.sort(axis=1)
        uniq, inv = np.unique(edges, axis=0, return_inverse=True)
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

    mat = material or Material(ka=(0.05, 0.05, 0.05), kd=(0.7, 0.7, 0.75),
                               ks=(0.4, 0.4, 0.4), ns=20.0)
    fv = faces.astype(np.int32)
    return MeshData(
        vertices=verts,
        normals=verts.copy(),   # unit sphere: normal == position
        faces_v=fv,
        faces_n=fv.copy(),
        face_mat=np.zeros(len(fv), np.int32),
        materials=[mat],
    )


def icosphere_scene(subdivisions: int, n_lights: int = 3) -> Scene:
    mesh = icosphere_mesh(subdivisions)
    lights_pos = np.array([[5.0, 5.0, 5.0], [-5.0, 5.0, 5.0], [0.0, -5.0, 5.0]])
    lights_col = np.array([[1.0, 1.0, 1.0], [1.0, 0.3, 0.3], [0.3, 0.3, 1.0]])
    camera = Camera.create([0.0, 0.0, 3.0], [0.0, 0.0, -1.0], 1.04719755)
    return Scene(meshes={"ico": mesh},
                 objects=[SceneObject(1, "ico", np.zeros(3))],
                 light_pos=lights_pos[:n_lights], light_col=lights_col[:n_lights],
                 camera=camera)

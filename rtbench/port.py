"""The benchmark's inputs in the program's types: a SceneSpec as the
program's Scene (which the program bakes itself), a Pose as its Camera."""

from __future__ import annotations

import numpy as np


def scene(spec):
    from distributed_raytracer_tpu_torch.models.camera import Camera
    from distributed_raytracer_tpu_torch.models.objparse import (Material,
                                                                 MeshData)
    from distributed_raytracer_tpu_torch.models.scene import (Scene,
                                                              SceneObject)

    meshes = {}
    for name, m in spec.meshes.items():
        ka, kd, ks, ns = m.material
        faces = np.asarray(m.faces, np.int32)
        meshes[name] = MeshData(
            vertices=np.asarray(m.vertices, np.float64),
            normals=np.asarray(m.normals, np.float64), faces_v=faces,
            faces_n=faces.copy(), face_mat=np.zeros(len(faces), np.int32),
            materials=[Material(ka=tuple(ka), kd=tuple(kd), ks=tuple(ks),
                                ns=float(ns))])
    objects = [SceneObject(i + 1, name, np.asarray(pos, np.float64))
               for i, (name, pos) in enumerate(spec.instances)]
    return Scene(meshes=meshes, objects=objects,
                 light_pos=np.asarray(spec.light_pos, np.float64),
                 light_col=np.asarray(spec.light_col, np.float64),
                 camera=Camera.create(spec.cam_pos, spec.cam_dir, spec.fov))


def camera(pose):
    from distributed_raytracer_tpu_torch.models.camera import Camera

    return Camera(pos=pose.pos.copy(), forward=pose.forward.copy(),
                  left=pose.left.copy(), up=pose.up.copy(), fov=pose.fov)

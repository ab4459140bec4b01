"""An n x n grid of copies of a base scene's first mesh, in the plane z = 0,
with the base camera pulled back to frame it.

Copied from distributed_raytracer_tpu_torch/utils/scenes.py:61-82
(`instanced_grid`), the logic unchanged. Parameters: {"base": a scene
object of its own (generator and parameters), "n": int, "spacing": float
(3.0)}.
"""

from __future__ import annotations

import numpy as np

from rtbench import scenes
from rtbench.scenes import SceneSpec


def make(params: dict, cache_dir: str) -> SceneSpec:
    base = scenes.make(params["base"], cache_dir)
    n = int(params["n"])
    spacing = float(params.get("spacing", 3.0))
    name, first = base.instances[0]
    instances = []
    for gy in range(n):
        for gx in range(n):
            offset = np.array([(gx - (n - 1) / 2.0) * spacing,
                               (gy - (n - 1) / 2.0) * spacing, 0.0])
            instances.append((name, first + offset))
    forward = base.cam_dir / np.linalg.norm(base.cam_dir)
    return SceneSpec(meshes={name: base.meshes[name]}, instances=instances,
                     light_pos=base.light_pos.copy(),
                     light_col=base.light_col.copy(),
                     cam_pos=base.cam_pos - forward * (spacing * n * 0.8),
                     cam_dir=forward, fov=base.fov)

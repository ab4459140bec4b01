"""The benchmark's scenes: triangles made here, handed to the program and to
the plain reference alike.

A scene is described in a configuration's "scene" object, whose
"generator" names a module of this folder (`scenes/<generator>.py`), found
by name. Each generator module defines

    make(params: dict, cache_dir: str) -> SceneSpec

and reads nothing but its parameters (and its own files in `cache_dir`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from rtbench import spec

# Material: (ka, kd, ks, ns), each colour an (r, g, b) tuple.
Material = Tuple[tuple, tuple, tuple, float]


@dataclasses.dataclass
class Mesh:
    vertices: np.ndarray    # (V, 3) float64
    normals: np.ndarray     # (V, 3) float64 unit vertex normals
    faces: np.ndarray       # (F, 3) int32 vertex (and normal) indices
    material: Material


@dataclasses.dataclass
class SceneSpec:
    meshes: Dict[str, Mesh]
    instances: List[Tuple[str, np.ndarray]]   # (mesh name, (3,) offset)
    light_pos: np.ndarray                       # (L, 3) float64
    light_col: np.ndarray                       # (L, 3) float64 in [0, 1]
    cam_pos: np.ndarray                         # (3,) float64
    cam_dir: np.ndarray                         # (3,) float64
    fov: float                                  # horizontal, radians


def make(scene: dict, cache_dir: str) -> SceneSpec:
    """The SceneSpec of a configuration's "scene" object."""
    params = {k: v for k, v in scene.items() if k != "generator"}
    return spec.load_module("scenes", scene["generator"]).make(params,
                                                               cache_dir)

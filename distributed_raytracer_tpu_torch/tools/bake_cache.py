"""Disk cache for expensive scene bakes (the multi-million-triangle configs).

The counterpart of the JAX package's tools/bake_cache.py, on this
package's SceneArrays, BlockBVH and Camera. Baking the 5.24 M-triangle
icosphere (BASELINE config 5) costs the mesh synthesis, the float64
intersection precompute, the Morton sort, the block AABBs and the packing;
this caches the finished (SceneArrays, BlockBVH, camera) bundle as an
uncompressed .npz, which later runs read back instead.

The layout, the file names, VERSION and the directory (DRT_SCENE_CACHE,
else .scene_cache/ at the repository root) are the JAX tool's, so either
package reads a bundle the other wrote.

    python -m distributed_raytracer_tpu_torch.tools.bake_cache [SUB ...]

prebuilds the icosphere bundles of the given subdivision levels (default
9 and 8).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from distributed_raytracer_tpu_torch.models.bvh import BlockBVH
from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import SceneArrays

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# Bump when bake_bvh/packing layout changes invalidate cached bundles (the
# JAX tool's number: both read one cache).
VERSION = 1


def cache_dir() -> str:
    return os.environ.get("DRT_SCENE_CACHE",
                          os.path.join(_REPO_ROOT, ".scene_cache"))


def _path(name: str) -> str:
    return os.path.join(cache_dir(), f"{name}_v{VERSION}.npz")


def save_bundle(name: str, arrays: SceneArrays, tree: BlockBVH,
                camera: Camera) -> str:
    os.makedirs(cache_dir(), exist_ok=True)
    path = _path(name)
    payload = {f"a_{f}": np.asarray(getattr(arrays, f))
               for f in SceneArrays._fields}
    np.savez(path, t_lo=tree.block_lo, t_hi=tree.block_hi,
             t_bs=np.int64(tree.block_size),
             cam_pos=np.asarray(camera.pos, np.float64),
             cam_fwd=np.asarray(camera.forward, np.float64),
             cam_fov=np.float64(camera.fov), **payload)
    return path


def load_bundle(name: str):
    """(SceneArrays, BlockBVH, Camera) or None if not cached."""
    path = _path(name)
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        arrays = SceneArrays(**{f: d[f"a_{f}"] for f in SceneArrays._fields})
        tree = BlockBVH(block_lo=d["t_lo"], block_hi=d["t_hi"],
                        block_size=int(d["t_bs"]))
        cam = Camera.create(pos=d["cam_pos"], direction=d["cam_fwd"],
                            fov=float(d["cam_fov"]))
    return arrays, tree, cam


def load_icosphere(subdivisions: int, build_if_missing: bool = True):
    """An icosphere bundle by subdivision level (blocks of 128): level 9 =
    5.24 M triangles (the BASELINE config-5 scene), level 8 = 1.31 M.
    Builds, caches and returns it when it is missing (printing the
    synthesis, bake and write times) unless build_if_missing is False
    (then None)."""
    name = f"icosphere{subdivisions}_bs128"
    got = load_bundle(name)
    if got is not None or not build_if_missing:
        return got
    from distributed_raytracer_tpu_torch.utils import scenes

    t0 = time.perf_counter()
    scene = scenes.icosphere_scene(subdivisions)
    t1 = time.perf_counter()
    arrays, tree = scene.bake_bvh(block_size=128)
    t2 = time.perf_counter()
    save_bundle(name, arrays, tree, scene.camera)
    t3 = time.perf_counter()
    print(f"built and cached {name}: synthesis {t1 - t0:.1f} s, bake "
          f"{t2 - t1:.1f} s, write {t3 - t2:.1f} s", flush=True)
    return arrays, tree, scene.camera


def main(argv) -> int:
    for sub in ([int(a) for a in argv[1:]] or [9, 8]):
        arrays, tree, _ = load_icosphere(sub, build_if_missing=True)
        print(f"cached: {arrays.p0.shape[0]} tri slots, {tree.num_blocks} "
              f"blocks -> {_path(f'icosphere{sub}_bs128')}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

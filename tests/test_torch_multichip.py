"""Every multi-rank schedule of the port against the dense sharded frame.

The port's counterpart of the pixel checks of the JAX package's multi-chip
dry run (__graft_entry__.dryrun_multichip): one scene, 4 CPU ranks, 64x48,
and every schedule's frame held to the dense ray-sharded frame
(parallel/render_sharded.py) with the dry run's own test,
np.allclose(got, ref, atol=2e-5); the bounced schedules to the dense
bounced frame (ops/render.render_frame_bounced), the dynamic ones to the
dense frame of the moved scene baked afresh. The scene is four mirrored
spheres (instanced_grid(icosphere_scene(2), 2): 1,280 triangles in 10
leaf blocks of 128, so every rank holds geometry). The schedules: bands
(equal, balanced, bounced), the dense ring (both transports), the dense
halo, the culled halo (plain, bounced, dynamic, dynamic with bounces) and
the culled ring (plain, bounced, dynamic). Only --multihost is not ported.
"""

import copy

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu_torch.ops import render
from distributed_raytracer_tpu_torch.parallel import (halo, halo_bvh,
                                                      render_sharded,
                                                      render_sharded_bvh,
                                                      ring, ring_bvh)
from distributed_raytracer_tpu_torch.utils import scenes

W, H, N = 64, 48, 4
MESH = ["cpu"] * N


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def scene():
    return scenes.instanced_grid(scenes.icosphere_scene(2), 2)


@pytest.fixture(scope="module")
def moved(scene):
    """The scene with object 1 moved 0.2 along x (the dry run's diff)."""
    m = copy.deepcopy(scene)
    m.set_object_pos(1, np.asarray(m.objects[0].pos, np.float64)
                     + [0.2, 0.0, 0.0])
    return m


@pytest.fixture(scope="module")
def refs(scene, moved):
    """The dense sharded frame, the dense bounced frame (depth 1) and the
    dense bounced frame of the moved scene."""
    arrays = render.scene_on(scene.bake(), "cpu")
    dense = render_sharded.make_sharded_renderer(W, H, mesh=MESH)(
        arrays, scene.camera)
    bounced = render.render_frame_bounced(arrays, scene.camera, W, H, 1)
    moved_b = render.render_frame_bounced(render.scene_on(moved.bake(),
                                                          "cpu"),
                                          scene.camera, W, H, 1)
    moved_d = render.render_frame(render.scene_on(moved.bake(), "cpu"),
                                  scene.camera, W, H)
    assert (moved_d - dense).abs().max() > 0.1      # the object moved
    return {"dense": dense, "bounced": bounced, "moved": moved_d,
            "moved_bounced": moved_b}


def frame(name, scene, moved):
    """(the schedule's frame, the reference it is held to)."""
    cam = scene.camera
    if name in ("bands", "bands_balanced"):
        r = render_sharded_bvh.make_sharded_culled_renderer(
            scene, W, H, mesh=MESH, balance=name == "bands_balanced")
        return r(cam, verify=True), "dense"
    if name == "bands_bounced":
        r = render_sharded_bvh.make_sharded_bounced_renderer(scene, W, H, 1,
                                                             mesh=MESH)
        return r(cam, verify=True), "bounced"
    if name in ("ring_dense", "ring_dense_rdma"):
        r = ring.make_ring_renderer(ring.pad_for_ring(scene.bake(), N), W,
                                    H, mesh=MESH,
                                    use_rdma=name == "ring_dense_rdma")
        return r(cam), "dense"
    if name == "halo_dense":
        r = halo.make_halo_renderer(halo.pad_for_ring(scene.bake(), N), W, H,
                                    mesh=MESH)
        return r(cam), "dense"
    kind, _, variant = name.partition("_")
    cls = {"halo": halo_bvh.HaloCulledRenderer,
           "ring": ring_bvh.RingCulledRenderer}[kind]
    bounces = int("bounced" in variant)
    r = cls(scene, W, H, mesh=MESH, bounces=bounces,
            dynamic="dynamic" in variant)
    if "dynamic" in variant:
        return (r.render_dynamic(cam, moved.make_diff(), verify=True),
                "moved_bounced" if bounces else "moved")
    return r.render(cam, verify=True), "bounced" if bounces else "dense"


@pytest.mark.parametrize("name", [
    "bands", "bands_balanced", "bands_bounced", "ring_dense",
    "ring_dense_rdma", "halo_dense", "halo_culled", "halo_bounced",
    "halo_dynamic", "halo_dynamic_bounced", "ring_culled", "ring_bounced",
    "ring_dynamic"])
def test_schedule_matches_the_dense_sharded_frame(name, scene, moved, refs):
    img, ref = frame(name, scene, moved)
    got, want = img.numpy(), refs[ref].numpy()
    assert got.shape == (H, W, 3), (name, got.shape)
    if not np.allclose(got, want, atol=2e-5):
        raise AssertionError(
            f"{name}: pixels diverge from the {ref} frame (max |diff| = "
            f"{np.abs(got - want).max():.3e}, tol 2e-5)")
    assert got.max() > 0.1

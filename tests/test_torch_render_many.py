"""The port's batched frozen render (`CulledRenderer.render_many`) against
the JAX package's, and the port's frozen frames as CUDA graph replays.

Both renderers are built from ONE bake by the JAX package (as
tests/test_torch_render_bvh.py builds them); the JAX renderer runs its
Pallas kernels in interpret mode, the port's runs on device="cpu" (K eager
frames). Images agree to atol 2e-5 (the repository's bound for identical
arrays: the shading math may round differently by an ulp); the frozen
buckets are equal, and every frame of each batch counts exactly what its
package's own sync render of the pose counts. Those agree on the primary
levels and the hit tiles; the shadow counts of the tetrahedron's second
pose differ by one coarse cell (port 9, JAX 10) in the sync renders
already, before any batch: a shadow work-list difference between the two
packages that the images do not show, from the light gate at a light in
the plane of a face (test_shadow_gap_is_the_light_gate_under_xla_fusion;
ROADMAP Queue 3). The port's frames
equal its own render_fast of each pose bit for bit, and Camera and host
CameraArrays inputs give the same batch.

The `cuda`-marked tests need a card (they skip here): a replay is
bit-equal to the eager stages, a frame returned earlier is unchanged by
later calls, a refreeze recaptures, and render_many equals render_fast.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops.render_bvh import CulledRenderer as JaxRenderer
from distributed_raytracer_tpu.ops.render_bvh import _tile_bucket as jtile_bucket
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import from_reference
from distributed_raytracer_tpu_torch.ops import cull, frozen_graph, raygen, shade
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.ops.shade import PackedPrep
from distributed_raytracer_tpu_torch.utils import scenes

W, H = 64, 48
K = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_camera(cam) -> Camera:
    """The port's Camera with a JAX package Camera's float64 state."""
    return Camera(pos=np.array(cam.pos), forward=np.array(cam.forward),
                  left=np.array(cam.left), up=np.array(cam.up),
                  fov=float(cam.fov))


def poses(scene):
    """K JAX Cameras: the scene's, and one moved and turned."""
    return [scene.camera, scene.camera.move(0.3, leftward=True).yaw(0.2)]


@pytest.fixture(scope="module")
def ico():
    return jscenes.icosphere_scene(2)


def scene_of(request, name, ico):
    return request.getfixturevalue("tetra_scene") if name == "tetra" else ico


@pytest.mark.parametrize("name", ["tetra", "ico"])
def test_render_many_matches_jax(request, ico, name):
    scene = scene_of(request, name, ico)
    bake = scene.bake_bvh(block_size=64)
    jr = JaxRenderer(None, W, H, interpret=True, prebaked=bake)
    tr = CulledRenderer(None, W, H, prebaked=from_reference(*bake),
                        device="cpu")
    cams = poses(scene)
    jimgs, jcounts = jr.render_many([c.to_arrays() for c in cams])
    timgs, tcounts = tr.render_many([port_camera(c) for c in cams])
    assert tr.buckets() == jr._frozen_pads
    assert tuple(timgs.shape) == (K, H, W, 3)
    assert timgs.dtype == torch.float32 and tcounts.dtype == torch.int32
    np.testing.assert_allclose(timgs.numpy(), np.asarray(jimgs), atol=2e-5,
                               rtol=0)
    nl = tr.n_levels + 1
    for k, cam in enumerate(cams):
        jr.render(cam.to_arrays())
        tr.render(port_camera(cam))
        assert tuple(np.asarray(jcounts[k]).tolist()) == jr._last_counts
        assert tuple(tcounts[k].tolist()) == tr._last_counts
        assert tr._last_counts[:nl] == jr._last_counts[:nl]
    assert (timgs[0].sum(-1) > 0).float().mean() > 0.05


@pytest.mark.parametrize("name", ["tetra", "ico"])
def test_render_many_equals_render_fast(request, ico, name):
    """Every frame of the batch is render_fast's for its pose, bit for
    bit; a renderer with nothing frozen freezes on cameras[0]."""
    scene = scene_of(request, name, ico)
    prebaked = from_reference(*scene.bake_bvh(block_size=64))
    tr = CulledRenderer(None, W, H, prebaked=prebaked, device="cpu")
    cams = [port_camera(c) for c in poses(scene)]
    imgs, counts = tr.render_many(cams)
    ref = CulledRenderer(None, W, H, prebaked=prebaked, device="cpu")
    ref.freeze(cams[0])
    assert tr.buckets() == ref.buckets()
    for k, cam in enumerate(cams):
        assert torch.equal(imgs[k], tr.render_fast(cam))
    assert all(c <= p for row in counts.tolist()
               for c, p in zip(row, tr.buckets()))


def test_render_many_camera_forms_agree(ico):
    """Cameras and host CameraArrays give the same batch."""
    tr = CulledRenderer(None, W, H, prebaked=from_reference(
        *ico.bake_bvh(block_size=64)), device="cpu")
    cams = [port_camera(c) for c in poses(ico)]
    a_imgs, a_counts = tr.render_many(cams)
    b_imgs, b_counts = tr.render_many([c.to_arrays() for c in cams])
    assert torch.equal(a_imgs, b_imgs) and torch.equal(a_counts, b_counts)


def test_camera_packing_round_trips(ico):
    """camera_packed / camera_views carry a camera in one (13,) tensor:
    the same CameraArrays values as camera_arrays gives, from a Camera,
    host CameraArrays or CameraArrays of tensors."""
    cam = port_camera(ico.camera.yaw(0.4))
    want = raygen.camera_arrays(cam, "cpu")
    host = raygen.camera_packed(cam)
    dev = raygen.camera_packed(want)
    assert host.shape == (13,) and host.dtype == torch.float32
    assert torch.equal(host, dev)
    for got in (raygen.camera_views(host),
                raygen.camera_arrays(cam.to_arrays(), "cpu")):
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_cpu_frozen_frames_capture_nothing(ico):
    """On the CPU the frozen entry points run the eager stages: no graph
    is made or captured."""
    tr = CulledRenderer(None, W, H, prebaked=from_reference(
        *ico.bake_bvh(block_size=64)), device="cpu")
    before = dict(frozen_graph.COUNTS)
    tr.render_fast(port_camera(ico.camera), verify=True)
    tr.render_many([port_camera(c) for c in poses(ico)])
    tr.freeze_bounced(port_camera(ico.camera), 1)(port_camera(ico.camera))
    # No counter moves but the one bounced frame issued: nothing captured,
    # and no kernel launched (every stage B2 took the plain path).
    assert frozen_graph.COUNTS == dict(
        before, bounced_frames=before["bounced_frames"] + 1)
    assert tr._graphs == {}


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_renderer():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    scene = scenes.icosphere_scene(4)
    r = CulledRenderer(scene, 256, 192, device="cuda")
    r.render(scene.camera, block=True)
    r.freeze(scene.camera)
    yield scene, r
    r.release_graphs()


def orbit(scene, n):
    from distributed_raytracer_tpu_torch.runtime import animation

    return animation.orbit_camera_path(scene.camera, n, radius=3.0)


@pytest.mark.cuda
def test_cuda_replay_equals_eager(cuda_renderer):
    scene, r = cuda_renderer
    for cam in orbit(scene, 4):
        got = r.render_fast(cam)
        want, _ = r._full(r.dev_scene, r.buckets(),
                          raygen.camera_arrays(cam, r.device))
        assert torch.equal(got, want)
    assert r._graphs["fast"].key is not None


@pytest.mark.cuda
def test_cuda_held_frame_unchanged(cuda_renderer):
    scene, r = cuda_renderer
    cams = orbit(scene, 3)
    first = r.render_fast(cams[0])
    copy = first.clone()
    r.render_fast(cams[1])
    r.render_many(cams)
    torch.cuda.synchronize()
    assert torch.equal(first, copy)


@pytest.mark.cuda
def test_cuda_refreeze_recaptures(cuda_renderer):
    scene, r = cuda_renderer
    away = scene.camera.yaw(3.14159)
    small = CulledRenderer(None, 256, 192, prebaked=(r.arrays_host, r.tree),
                           device="cuda")
    small.render(away, block=True)
    small.freeze(away)
    caps = frozen_graph.COUNTS["captures"]
    pads = small.buckets()
    got = small.render_fast(scene.camera, verify=True)
    assert small.buckets() != pads
    assert frozen_graph.COUNTS["captures"] >= caps + 2
    want = small.render(scene.camera, block=True)
    assert float((got - want).abs().max()) <= 2e-5
    small.release_graphs()


@pytest.mark.cuda
def test_cuda_render_many_equals_render_fast(cuda_renderer):
    scene, r = cuda_renderer
    cams = orbit(scene, 6)
    imgs, counts = r.render_many(cams)
    assert counts.shape == (6, len(r.buckets()))
    for k, cam in enumerate(cams):
        assert torch.equal(imgs[k], r.render_fast(cam))


def test_shadow_gap_is_the_light_gate_under_xla_fusion(tetra_scene):
    """Where the shadow counts differ from JAX's (the tetrahedron's pose
    moved 0.3 left and turned 0.2 at 64x48: coarse and fine 9 in the port,
    10 in JAX), the light gate decides it. Light 1, (-4, 2, 3), lies in the
    plane x + y + z = 1 of the tetrahedron's slanted face, so l.n is 0 in
    real arithmetic on that face and its rounding's sign opens or shuts the
    gate (contribution > 0):

      - on JAX's own shading prep, the port's light_gates_rows equals the
        JAX gate run op by op (no fusion) bit for bit: both sum in the JAX
        source's order;
      - under jit, XLA fuses the hit point and the gate's dot products into
        multiply-adds, and the gate differs from the op-by-op one only on
        light 1's rays with |l.n| < 1e-7;
      - the extra shadow cell comes from those rays alone: the jitted
        shadow rays with the op-by-op gate give the op-by-op cell count.
    """
    w, h = 64, 48
    bake = tetra_scene.bake_bvh(block_size=64)
    jr = JaxRenderer(None, w, h, interpret=True, prebaked=bake)
    cam = tetra_scene.camera.move(0.3, leftward=True).yaw(0.2).to_arrays()
    rays, ti, m1, e1, c1 = jr._stage_a(cam, jr._perm, jr.block_lo,
                                       jr.block_hi)
    pads, _ = jr._size_pads(ti, m1, e1, c1, jr.block_lo, jr.block_hi)
    hits, hcount, _ = jr._stage_b1_fn(pads, jr.arrays, jr.tris_packed,
                                      jr.tris_dirs, jr.block_lo,
                                      jr.block_hi, rays, ti, m1, e1, c1)
    args = (jr.arrays, jr.shade_tbl, jr.block_lo, jr.block_hi, rays, hits)
    ht_pad = jtile_bucket(int(hcount), jr.n_tiles)
    eager = jr._stage_b2_fn(ht_pad, *args)
    fused = jax.jit(functools.partial(jr._stage_b2_fn, ht_pad))(*args)
    t = lambda x: torch.from_numpy(np.array(x))
    port_gate = shade.light_gates_rows(
        t(jr.arrays.light_col), t(rays[0:3, 0]),
        PackedPrep(*(t(f) for f in eager[3])), t(eager[2].valid))
    eager_live, fused_live = np.asarray(eager[4]), np.asarray(fused[4])
    assert np.array_equal(port_gate.numpy(), eager_live)

    flipped = np.argwhere(eager_live != fused_live)
    assert len(flipped) > 0 and set(flipped[:, 0]) == {1}
    q = np.asarray(fused[3].q, np.float64)
    normal = np.asarray(fused[3].normal, np.float64)
    for li, ray in flipped:
        assert abs(q[li, 3:6, ray] @ normal[:, ray]) < 1e-7
    assert int(fused[8]) == int(eager[8]) + 1      # the extra coarse cell

    q_rev = t(fused[3].q_rev)
    blo, bhi = t(jr.block_lo), t(jr.block_hi)

    def coarse_cells(live_l):
        total = 0
        for li in range(q_rev.shape[0]):
            hull = cull.tile_intervals_packed(q_rev[li], jr.rt,
                                              live=t(live_l[li]),
                                              use_tmax=True)
            total += int(cull.multilevel_mask(hull, blo, bhi,
                                              jr.groups)[2])
        return total

    assert coarse_cells(fused_live) == int(fused[8])
    assert coarse_cells(eager_live) == int(eager[8])

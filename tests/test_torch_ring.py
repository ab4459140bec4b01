"""The PyTorch port's geometry ring (parallel/ring.py) and its kernels' plain
versions (ops/ring_trace.py: K6, K7) against the JAX package's.

The JAX side runs on the CPU with conftest's virtual devices, its Pallas
ring kernels in interpret mode (which simulates the remote DMAs and
semaphores); the port's ranks are all the CPU. Both sides start from ONE
JAX bake (the port's through arrays_from_reference).
  - Kernel plain versions: ids and any-hit flags equal on every ray, t to
    rtol 1e-6 (elementwise f32 pair math in the same order on both sides;
    XLA may contract a product into a fused multiply-add).
  - Ring renderer: each transport against the same transport in JAX, atol
    2e-5; each against the port's dense frame to the JAX tests' bounds
    (tests/test_ring_rdma.py: under 0.2% of pixels more than 2/255 off,
    mean under 1e-4).
The CUDA kernels themselves are held against the plain versions by the
`cuda`-marked test, on a card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

from distributed_raytracer_tpu.ops import raygen as jraygen
from distributed_raytracer_tpu.ops.pallas import bsr_trace as jbsr
from distributed_raytracer_tpu.ops.pallas import ring_trace as jring_trace
from distributed_raytracer_tpu.parallel import ring as jring
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.scene import arrays_from_reference
from distributed_raytracer_tpu_torch.ops import bsr_trace, render, ring_trace
from distributed_raytracer_tpu_torch.parallel import mesh, ring
from distributed_raytracer_tpu_torch.utils import tracing

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

W, H = 64, 48
RT = 128


@pytest.fixture(scope="module")
def ico():
    return jscenes.icosphere_scene(2)


def jax_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jax.make_mesh((n,), (jring.AXIS,), devices=jax.devices()[:n])


def cpu_ranks(n):
    return mesh.Ranks(mesh.make_mesh(n, "cpu"))


def frame_inputs(scene, n):
    """(rays (8, R), tris (T_pad, 16), t_total) of the frame's primary rays,
    the triangles padded to a multiple of n * 128 as the kernel transport
    pads them."""
    tris = jbsr.pack_tris(scene.bake())
    t = tris.shape[0]
    t_pad = -(-t // (n * 128)) * n * 128
    padded = np.zeros((t_pad, 16), np.float32)
    padded[:t] = tris
    cam = scene.camera.to_arrays()
    dirs = jraygen.ray_directions_flat(cam, W, H,
                                       jnp.arange(W * H, dtype=jnp.int32))
    return np.array(jbsr.pack_rays(jnp.asarray(cam.pos), dirs)), padded, t


def split(x, n, axis):
    return [torch.from_numpy(np.ascontiguousarray(p))
            for p in np.split(x, n, axis=axis)]


def pallas(fn, n, rays, tris, excl):
    """A JAX ring kernel under shard_map over n virtual devices."""
    f = functools.partial(fn, n=n, rt=RT, tb=128, axis=jring.AXIS,
                          interpret=pltpu.InterpretParams())
    out = (P(jring.AXIS), P(jring.AXIS)) if fn is jring_trace.ring_nearest \
        else P(jring.AXIS)
    sharded = jax.jit(shard_map(
        f, mesh=jax_mesh(n),
        in_specs=(P(None, jring.AXIS), P(None, jring.AXIS), P(jring.AXIS)),
        out_specs=out, check_vma=False))
    return sharded(jnp.asarray(rays), jnp.asarray(tris.T.copy()),
                   jnp.asarray(excl))


def exclusion(t_total, r, on: bool):
    rng = np.random.default_rng(11)
    if not on:
        return np.full(r, -1, np.int32)
    return np.where(rng.uniform(size=r) < 0.5, rng.integers(0, t_total, r),
                    -1).astype(np.int32)


@pytest.mark.parametrize("n,excluded", [(1, False), (4, False), (4, True)])
def test_ring_nearest_ref_matches_pallas(ico, n, excluded):
    rays, tris, t_total = frame_inputs(ico, n)
    excl = exclusion(t_total, rays.shape[1], excluded)
    wt, wi = (np.asarray(a) for a in pallas(jring_trace.ring_nearest, n,
                                            rays, tris, excl))
    gt, gi = ring_trace.ring_nearest_ref(
        cpu_ranks(n), split(rays, n, 1), split(tris, n, 0),
        split(excl, n, 0), rt=RT)
    gt, gi = torch.cat(gt).numpy(), torch.cat(gi).numpy()
    hit = np.isfinite(wt)
    assert 0.2 < hit.mean() < 0.8
    np.testing.assert_array_equal(np.isfinite(gt), hit)
    np.testing.assert_allclose(gt[hit], wt[hit], rtol=1e-6, atol=0)
    # Ids on every ray: ties to the lowest global id; a miss is (inf, 0).
    np.testing.assert_array_equal(gi, wi)
    assert (gi[~hit] == 0).all()
    if excluded:
        assert (gi[hit] != excl[hit]).all()


@pytest.mark.parametrize("n", [1, 4])
def test_ring_any_ref_matches_pallas(ico, n):
    """Shadow-style queries with a non-trivial exclusion and t_max: the
    nearest hit's t times a factor in [0.5, 1.5], so about half the hitting
    rays stop short of their hit."""
    rays, tris, t_total = frame_inputs(ico, n)
    r = rays.shape[1]
    best_t, best_i = ring_trace.ring_nearest_ref(
        cpu_ranks(n), split(rays, n, 1), split(tris, n, 0), rt=RT)
    best_t, best_i = torch.cat(best_t).numpy(), torch.cat(best_i).numpy()
    rng = np.random.default_rng(3)
    rays = rays.copy()
    rays[6] = np.where(np.isfinite(best_t),
                       best_t * rng.uniform(0.5, 1.5, r), np.inf)
    # Half the rays exclude their own nearest triangle.
    excl = np.where(rng.uniform(size=r) < 0.5, best_i, -1).astype(np.int32)
    want = np.asarray(pallas(jring_trace.ring_any, n, rays, tris, excl))
    got = torch.cat(ring_trace.ring_any_ref(
        cpu_ranks(n), split(rays, n, 1), split(tris, n, 0),
        split(excl, n, 0), rt=RT)).numpy()
    np.testing.assert_array_equal(got, want)
    hit = np.isfinite(best_t)
    assert 0 < got[hit].sum() < hit.sum()


def test_cpu_wrappers_use_plain_versions(ico):
    n = 2
    rays, tris, _ = frame_inputs(ico, n)
    ranks = cpu_ranks(n)
    args = (ranks, split(rays, n, 1), split(tris, n, 0))
    before = dict(tracing.COUNTS)
    for got, want in zip(ring_trace.ring_nearest(*args, rt=RT),
                         ring_trace.ring_nearest_ref(*args, rt=RT)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    for g, w in zip(ring_trace.ring_any(*args, rt=RT),
                    ring_trace.ring_any_ref(*args, rt=RT)):
        assert torch.equal(g, w)
    assert tracing.COUNTS == before


def test_wrappers_refuse_what_the_kernels_do_not_take(ico):
    n = 2
    rays, tris, _ = frame_inputs(ico, n)
    ranks = cpu_ranks(n)
    r, t = split(rays, n, 1), split(tris, n, 0)
    with pytest.raises(ValueError, match="rt="):
        ring_trace.ring_nearest(ranks, r, t, rt=384)
    with pytest.raises(ValueError, match="multiple of 128"):
        ring_trace.ring_nearest(ranks, r, [x[:100] for x in t], rt=RT)
    with pytest.raises(ValueError, match="for 2 ranks"):
        ring_trace.ring_any(ranks, r[:1], t, rt=RT)
    with pytest.raises(ValueError, match="exclude"):
        ring_trace.ring_any(ranks, r, t, [torch.zeros(x.shape[1],
                                                      dtype=torch.int64)
                                          for x in r], rt=RT)
    with pytest.raises(ValueError, match="contiguous"):
        ring_trace.ring_any(ranks, r, [x.T.contiguous().T for x in t], rt=RT)


def ring_pair(scene, n, use_rdma):
    """(JAX frame, the port's renderer) of one transport."""
    a = scene.bake()
    want = np.asarray(jring.make_ring_renderer(
        jring.pad_for_ring(a, n), W, H, mesh=jax_mesh(n),
        use_rdma=use_rdma)(scene.camera))
    port = ring.make_ring_renderer(
        ring.pad_for_ring(arrays_from_reference(a), n), W, H,
        mesh=mesh.make_mesh(n, "cpu"), use_rdma=use_rdma)
    return want, port


def dense_frame(scene):
    return render.render_frame(render.scene_on(
        arrays_from_reference(scene.bake()), "cpu"), scene.camera, W,
        H).numpy()


def within_dense_bounds(got, dense):
    diff = np.abs(got - dense)
    assert (diff.max(-1) > 2 / 255).mean() < 0.002
    assert diff.mean() < 1e-4


@pytest.mark.parametrize("use_rdma", [False, True])
def test_ring_renderer_matches_jax(ico, use_rdma):
    """4 ranks, each transport against the same transport in JAX (384
    triangles: not a multiple of 4 * 128, so the kernel transport pads)."""
    want, port = ring_pair(ico, 4, use_rdma)
    assert port.mesh == (torch.device("cpu"),) * 4
    got = port(ico.camera)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    within_dense_bounds(got.numpy(), dense_frame(ico))
    assert (want.sum(-1) > 0).mean() > 0.2


@pytest.mark.parametrize("use_rdma", [False, True])
@pytest.mark.parametrize("n", [1, 3])
def test_ring_renderer_matches_dense(tetra_scene, n, use_rdma):
    """One rank, and three ranks over the tetra scene's 128 triangles (a
    count neither 3 nor 3 * 128 divides: both transports pad)."""
    a = arrays_from_reference(tetra_scene.bake())
    padded = ring.pad_for_ring(a, n)
    assert padded.p0.shape[0] % n == 0
    if n == 3:
        assert padded.p0.shape[0] == 129
        with pytest.raises(ValueError, match="pad_for_ring"):
            ring.make_ring_renderer(a, W, H, mesh=mesh.make_mesh(n, "cpu"))
    r = ring.make_ring_renderer(padded, W, H, mesh=mesh.make_mesh(n, "cpu"),
                                use_rdma=use_rdma)
    dense = dense_frame(tetra_scene)
    got = r(tetra_scene.camera).numpy()
    within_dense_bounds(got, dense)
    np.testing.assert_allclose(got, dense, atol=2e-5, rtol=0)
    assert r.device_fn(tetra_scene.camera).shape[0] >= W * H


def test_ring_renderer_without_lights():
    """Ambient only: no shadow rotation runs."""
    scene = jscenes.icosphere_scene(1, n_lights=0)
    for use_rdma in (False, True):
        r = ring.make_ring_renderer(
            ring.pad_for_ring(arrays_from_reference(scene.bake()), 2), W, H,
            mesh=mesh.make_mesh(2, "cpu"), use_rdma=use_rdma)
        np.testing.assert_allclose(r(scene.camera).numpy(),
                                   dense_frame(scene), atol=2e-5, rtol=0)


def test_pack_rays_matches_jax():
    rng = np.random.default_rng(4)
    o = rng.normal(size=(50, 3)).astype(np.float32)
    d = rng.normal(size=(50, 3)).astype(np.float32)
    tmax = rng.uniform(1, 2, 50).astype(np.float32)
    for origin, t in ((o[0], None), (o, tmax)):
        want = np.asarray(jbsr.pack_rays(
            jnp.asarray(origin), jnp.asarray(d),
            None if t is None else jnp.asarray(t)))
        got = bsr_trace.pack_rays(torch.from_numpy(origin),
                                  torch.from_numpy(d),
                                  None if t is None else torch.from_numpy(t))
        np.testing.assert_array_equal(got.numpy(), want)


def mixed_origins(rays):
    """The camera rays with one ray of every odd tile moved off the camera
    by one ulp of x: even tiles share one origin (K6 folds it into the
    staged rows), odd tiles do not (K6 dots each ray's origin in)."""
    rays = rays.copy()
    for tile in range(1, rays.shape[1] // RT, 2):
        r = tile * RT + tile % RT
        rays[0, r] = np.nextafter(rays[0, r], np.float32(np.inf))
    return rays


@pytest.mark.cuda
@pytest.mark.parametrize("origins", ["camera", "mixed"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_cuda_ring_kernels_match_plain_versions(ico, n, origins):
    """On a card: K6 and K7 over n ranks sharing cuda:0 equal their plain
    versions (same rotation, same streams) exactly, one launch per rank and
    ring step each; with every tile's rays from the camera, and with a
    launch whose tiles mix shared and per-ray origins."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    rays, tris, t_total = frame_inputs(ico, n)
    if origins == "mixed":
        rays = mixed_origins(rays)
    dev = torch.device("cuda:0")
    ranks = mesh.Ranks([dev] * n)
    r = [x.to(dev) for x in split(rays, n, 1)]
    t = [x.to(dev) for x in split(tris, n, 0)]
    e = [x.to(dev) for x in split(exclusion(t_total, rays.shape[1], True),
                                  n, 0)]
    before = dict(tracing.COUNTS)
    got = ring_trace.ring_nearest(ranks, r, t, e, rt=RT)
    want = ring_trace.ring_nearest_ref(ranks, r, t, e, rt=RT)
    q = [x.clone() for x in r]
    for x, bt in zip(q, want[0]):
        x[6] = torch.where(torch.isfinite(bt), bt * 0.9, float("inf"))
    hit = ring_trace.ring_any(ranks, q, t, e, rt=RT)
    hit_ref = ring_trace.ring_any_ref(ranks, q, t, e, rt=RT)
    torch.cuda.synchronize()
    assert tracing.COUNTS == dict(
        before, ring_nearest=before["ring_nearest"] + n * n,
        ring_any=before["ring_any"] + n * n)
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got[0], want[0]))
    assert all(torch.equal(a, b) for a, b in zip(hit, hit_ref))

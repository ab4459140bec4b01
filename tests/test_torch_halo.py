"""The port's dense halo schedule (parallel/halo.py) and the rank model's
all_to_all (parallel/mesh.py) against the JAX package's.

The JAX side runs on conftest's virtual CPU devices; the port's ranks are
[cpu] * n. Both sides start from ONE JAX bake (the port's through
arrays_from_reference), so they number the triangles alike.
  - all_to_all over n = 1, 2, 4 ranks equals the chunk transposition of
    jax.lax.all_to_all(split_axis=0, concat_axis=0, tiled=True), for rows
    of 1-D and 2-D parts, bit for bit.
  - make_halo_renderer: images within atol 2e-5 of JAX's and of the port's
    dense frame; halo_density within 1e-6 of JAX's; shard_bounds bit-equal.
No kernel runs on this path (the JAX package's dense halo has none).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_raytracer_tpu.models import bvh as jbvh
from distributed_raytracer_tpu.parallel import halo as jhalo
from distributed_raytracer_tpu.parallel import ring as jring
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.scene import arrays_from_reference
from distributed_raytracer_tpu_torch.ops import render
from distributed_raytracer_tpu_torch.parallel import halo, mesh
from distributed_raytracer_tpu_torch.parallel.ring import HitPayload

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

W, H = 64, 48


def jax_mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} virtual devices")
    return jax.make_mesh((n,), (jhalo.AXIS,), devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def morton_ico():
    """icosphere_scene(2) (320 triangles) Morton-ordered, so contiguous
    shards are spatially compact: (scene, JAX bake)."""
    scene = jscenes.icosphere_scene(2)
    a = scene.bake()
    order = jbvh.morton_order(np.asarray(a.p0), np.asarray(a.e1),
                              np.asarray(a.e2), scene.num_tris)
    return scene, jbvh.reorder_scene(a, order)


@pytest.fixture(scope="module")
def scenes(tetra_scene, morton_ico):
    return {"tetra": (tetra_scene, tetra_scene.bake()),
            "morton_ico": morton_ico}


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("shape", [(8,), (8, 5)], ids=["1d", "2d"])
def test_all_to_all_is_the_chunk_transposition(n, shape):
    rng = np.random.default_rng(n)
    parts = [rng.normal(size=(n * shape[0],) + shape[1:]).astype(np.float32)
             for _ in range(n)]
    got = mesh.all_to_all(mesh.Ranks(mesh.make_mesh(n, "cpu")),
                          [torch.from_numpy(p) for p in parts])
    c = shape[0]
    for dst in range(n):
        want = np.concatenate([p[dst * c:(dst + 1) * c] for p in parts])
        np.testing.assert_array_equal(got[dst].numpy(), want)
    # JAX's collective gives the same rows.
    fn = shard_map(lambda x: jax.lax.all_to_all(
        x, jhalo.AXIS, split_axis=0, concat_axis=0, tiled=True),
        mesh=jax_mesh(n), in_specs=P(jhalo.AXIS), out_specs=P(jhalo.AXIS))
    want = np.asarray(jax.jit(fn)(jnp.asarray(np.concatenate(parts))))
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    ints = mesh.all_to_all(mesh.Ranks(mesh.make_mesh(n, "cpu")),
                           [torch.arange(n * 3, dtype=torch.int32)] * n)
    assert all(g.dtype == torch.int32 and g.shape == (n * 3,) for g in ints)


def test_all_to_all_needs_whole_chunks():
    with pytest.raises(ValueError, match="chunks"):
        mesh.all_to_all(mesh.Ranks(mesh.make_mesh(2, "cpu")),
                        [torch.zeros(3), torch.zeros(3)])


def test_all_gather_along_a_dim():
    xs = [torch.full((2, 3), float(r)) for r in range(3)]
    out = mesh.all_gather(mesh.Ranks(mesh.make_mesh(3, "cpu")), xs, dim=1)
    assert all(torch.equal(o, torch.cat(xs, dim=1)) for o in out)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["tetra", "morton_ico"])
def test_halo_matches_jax_and_dense(scenes, name, n):
    scene, a = scenes[name]
    want = jhalo.make_halo_renderer(jring.pad_for_ring(a, n), W, H,
                                    mesh=jax_mesh(n))
    port = halo.make_halo_renderer(
        halo.pad_for_ring(arrays_from_reference(a), n), W, H,
        mesh=mesh.make_mesh(n, "cpu"))
    assert port.mesh == (torch.device("cpu"),) * n
    got = port(scene.camera)
    assert got.shape == (H, W, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want(scene.camera)),
                               atol=2e-5, rtol=0)
    dense = render.render_frame(render.scene_on(arrays_from_reference(a),
                                                "cpu"), scene.camera, W, H)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-5, rtol=0)
    assert got.max() > 0.1
    assert port.device_fn(scene.camera).shape[0] >= W * H


@pytest.mark.parametrize("n", [2, 4])
def test_halo_density_matches_jax(morton_ico, n):
    scene, a = morton_ico
    padded = jring.pad_for_ring(a, n)
    want = jhalo.make_halo_renderer(padded, 32, 24, mesh=jax_mesh(n))
    port = halo.make_halo_renderer(arrays_from_reference(padded), 32, 24,
                                   mesh=mesh.make_mesh(n, "cpu"))
    d = port.halo_density(scene.camera)
    assert abs(d - want.halo_density(scene.camera)) <= 1e-6
    assert 0.0 < d < 1.0


@pytest.mark.parametrize("n", [1, 2, 4])
def test_shard_bounds_bit_equal(scenes, n):
    for _, a in scenes.values():
        padded = jring.pad_for_ring(a, n)
        want = jhalo.shard_bounds(padded, n)
        got = halo.shard_bounds(arrays_from_reference(padded), n)
        for g, w in zip(got, want):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="pad_for_ring"):
        halo.shard_bounds(arrays_from_reference(scenes["tetra"][1]), 3)


def test_segment_mask_matches_jax():
    """Rays from inside, outside, along axes (zero components) and short
    segments against one box."""
    rng = np.random.default_rng(7)
    o = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d[::5, 0] = 0.0
    d[::7, 1:] = 0.0
    t = rng.uniform(0.0, 3.0, 256).astype(np.float32)
    t[::3] = np.inf
    lo, hi = np.float32([-0.5, -0.4, -0.3]), np.float32([0.5, 0.6, 0.2])
    want = np.asarray(jhalo._segment_mask(*map(jnp.asarray, (o, d, t, lo,
                                                             hi))))
    got = halo._segment_mask(*map(torch.from_numpy, (o, d, t, lo, hi)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < 256
    shared = halo._segment_mask(torch.from_numpy(o[0]), torch.from_numpy(d),
                                torch.from_numpy(t), torch.from_numpy(lo),
                                torch.from_numpy(hi))
    np.testing.assert_array_equal(shared.numpy(), np.asarray(
        jhalo._segment_mask(jnp.asarray(o[0]), jnp.asarray(d),
                            jnp.asarray(t), jnp.asarray(lo),
                            jnp.asarray(hi))))


def test_fold_takes_least_t_then_least_id():
    """Three sources: a tie at one t goes to the least global id whatever
    the source order; misses (inf, 2**30) are the fold's identity."""
    t = torch.tensor([[1.0, np.inf, 2.0], [1.0, 3.0, 2.0],
                      [0.5, np.inf, 2.0]])
    tri = torch.tensor([[7, 2 ** 30, 9], [4, 5, 3], [8, 2 ** 30, 6]],
                       dtype=torch.int32)
    mat = tri + 100
    z = torch.zeros_like(t)
    z3 = torch.zeros(3, 3, 3)
    got = halo._fold_payloads(HitPayload(t=t, tri=tri, u=z, v=z, n0=z3,
                                         n1=z3, n2=z3, geo_n=z3, mat=mat), 3)
    assert got.t.tolist() == [0.5, 3.0, 2.0]
    assert got.tri.tolist() == [8, 5, 3] and got.mat.tolist() == [108, 105,
                                                                   103]

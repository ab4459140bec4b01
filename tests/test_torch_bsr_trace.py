"""The PyTorch port's traversal (ops/bsr_trace.py) against the JAX package's
Pallas kernels, which run here in interpret mode as the JAX package's own
tests run them.

The work lists and rays are the real inputs of two frames, each baked once
by the JAX package and rendered by the port's CPU renderer, whose launches
are recorded: icosphere_scene(3) at 64x48 (the shared-origin launches of
render()), and four mirrored spheres, instanced_grid(icosphere_scene(2), 2),
at 64x48 (the per-ray-origin launch of bounce 1 of render_bounced, whose
reflection rays hit the other spheres). Every work list stays far below the
JAX kernels' 16,384-item segment: past one segment the JAX reference leaves
some tiles' outputs undefined. Tolerances: ids and any-hit flags
exactly equal on every ray of the visited tiles; t to 1e-6 relative (the
pair math is elementwise f32 in the same operation order on both sides).
The CUDA kernels themselves are compared with the plain versions by the
`cuda`-marked test, on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops.pallas import bsr_trace as jbsr
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.scene import from_reference
from distributed_raytracer_tpu_torch.ops import bsr_trace as tbsr
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.utils import tracing

RT = 512


@pytest.fixture(scope="module")
def launches():
    """{name: (args as numpy, kwargs)} of the port renderer's two launches,
    plus the scene arrays."""
    scene = jscenes.icosphere_scene(3)
    arrays, tree = scene.bake_bvh(block_size=64)
    r = CulledRenderer(None, 64, 48, prebaked=from_reference(arrays, tree),
                       device="cpu")
    seen = {}
    originals = {n: getattr(tbsr, n) for n in ("bsr_nearest", "bsr_any")}

    def recorder(name):
        def call(*args, **kwargs):
            seen[name] = (tuple(a.numpy().copy() for a in args), kwargs)
            return originals[name](*args, **kwargs)
        return call

    try:
        for n in originals:
            setattr(tbsr, n, recorder(n))
        r.render(scene.camera.yaw(0.1))
    finally:
        for n, fn in originals.items():
            setattr(tbsr, n, fn)
    return dict(seen, arrays=arrays, tb=r.tb)


@pytest.fixture(scope="module")
def bounce_launch():
    """(args as numpy, kwargs) of the port's per-ray-origin nearest launch
    of bounce 1 (the second nearest launch of a depth-2 render_bounced)."""
    scene = jscenes.instanced_grid(jscenes.icosphere_scene(2), 2)
    r = CulledRenderer(None, 64, 48, prebaked=from_reference(
        *scene.bake_bvh(block_size=64)), device="cpu")
    seen = []
    original = tbsr.bsr_nearest

    def recorder(*args, **kwargs):
        seen.append((tuple(a.numpy().copy() for a in args), kwargs))
        return original(*args, **kwargs)

    try:
        tbsr.bsr_nearest = recorder
        r.render_bounced(scene.camera, 2)
    finally:
        tbsr.bsr_nearest = original
    assert len(seen) == 3
    assert r._last_bounce_counts[1][r.n_levels] > 0     # bounce 1 hits
    args, kw = seen[1]
    assert kw["shared_origin"] is False
    assert int(args[6]) <= 16384
    return args, kw


def visited(tile_ids, count, r):
    v = np.zeros(r // RT, bool)
    v[tile_ids[:min(int(count), len(tile_ids))]] = True
    return np.repeat(v, RT)


def test_pack_tris_matches(launches):
    np.testing.assert_array_equal(tbsr.pack_tris(launches["arrays"]),
                                  jbsr.pack_tris(launches["arrays"]))


def test_pack_rays_and_origin_fold_match(launches):
    tris = jbsr.pack_tris(launches["arrays"])
    rng = np.random.default_rng(5)
    origin = rng.normal(size=3).astype(np.float32)
    want = np.asarray(jbsr.pack_tris_origin(jnp.asarray(tris),
                                            jnp.asarray(origin)))
    got = tbsr.pack_tris_origin(torch.from_numpy(tris),
                                torch.from_numpy(origin)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    d = rng.normal(size=(3, 1024)).astype(np.float32)
    tmax = rng.uniform(1, 2, 1024).astype(np.float32)
    o_rows = rng.normal(size=(3, 1024)).astype(np.float32)
    for o, t in ((origin, None), (o_rows, tmax)):
        want = np.asarray(jbsr.pack_rays_rows(
            jnp.asarray(o), jnp.asarray(d),
            None if t is None else jnp.asarray(t)))
        got = tbsr.pack_rays_rows(torch.from_numpy(o), torch.from_numpy(d),
                                  None if t is None else torch.from_numpy(t))
        np.testing.assert_array_equal(got.numpy(), want)


def nearest_inputs(launch, carry):
    (rays, excl, tris, tile_ids, block_ids, entry, count), kw = launch
    r, t = rays.shape[1], tris.shape[0]
    init_t = init_i = gid_base = None
    if carry:
        rng = np.random.default_rng(9)
        near = rng.uniform(size=r) < 0.3
        init_t = np.where(near, rng.uniform(1.5, 4.0, r),
                          np.inf).astype(np.float32)
        init_i = np.where(near, rng.integers(0, t, r),
                          jbsr.BIG_IDX).astype(np.int32)
        excl = np.where(rng.uniform(size=r) < 0.5, rng.integers(0, t, r),
                        excl).astype(np.int32)
        gid_base = 7
    return (rays, excl, tris, tile_ids, block_ids, entry, count, init_t,
            init_i, gid_base, kw["tb"])


def check_nearest(launch, exit_every, carry):
    """The plain nearest against the Pallas kernel on one recorded launch,
    in the launch's origin form."""
    shared_origin = launch[1]["shared_origin"]
    (rays, excl, tris, tile_ids, block_ids, entry, count, init_t, init_i,
     gid_base, tb) = nearest_inputs(launch, carry)
    j = lambda a: None if a is None else jnp.asarray(a)
    wt, wi = jbsr.bsr_nearest(
        j(rays), j(excl), j(tris), j(tile_ids), j(block_ids), j(entry),
        j(count), j(init_t), j(init_i),
        None if gid_base is None else jnp.int32(gid_base),
        rt=RT, tb=tb, w_pad=len(tile_ids), interpret=True,
        shared_origin=shared_origin, exit_every=exit_every)
    t = lambda a: None if a is None else torch.from_numpy(a)
    gt, gi = tbsr.bsr_nearest_ref(
        t(rays), t(excl), t(tris), t(tile_ids), t(block_ids), t(entry),
        t(count), t(init_t), t(init_i), gid_base, rt=RT, tb=tb,
        shared_origin=shared_origin, exit_every=exit_every)
    vis = visited(tile_ids, count, rays.shape[1])
    wt, wi, gt, gi = (np.asarray(wt), np.asarray(wi), gt.numpy(), gi.numpy())
    assert gi.dtype == np.int32 and gt.dtype == np.float32
    np.testing.assert_array_equal(gi[vis], wi[vis])
    fin = np.isfinite(wt[vis])
    assert fin.sum() > 100                         # the frame has hits
    np.testing.assert_array_equal(np.isfinite(gt[vis]), fin)
    np.testing.assert_allclose(gt[vis][fin], wt[vis][fin], rtol=1e-6, atol=0)
    # Tiles the work list never names keep their initial value.
    want_t = np.full_like(gt, np.inf) if init_t is None else init_t
    np.testing.assert_array_equal(gt[~vis], want_t[~vis])
    return gt, gi


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("exit_every", [0, 8])
def test_bsr_nearest_ref_matches_pallas(launches, exit_every, carry):
    check_nearest(launches["bsr_nearest"], exit_every, carry)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("exit_every", [0, 8])
def test_bsr_nearest_rays_ref_matches_pallas(bounce_launch, exit_every,
                                             carry):
    """K3n: per-ray origins against the static pack_tris rows, with the
    previous bounce's hit ids excluded."""
    check_nearest(bounce_launch, exit_every, carry)


def any_rays_inputs(bounce_launch):
    """The bounce-1 rays as a per-ray-origin any-hit query: t_max is the
    ray's nearest hit t (from the plain nearest) times a random factor in
    [0.5, 1.5], so about half the hitting rays stop short of their hit;
    rays that hit nothing keep BIG_TMAX. A tenth of the rays are pre-seeded
    as hit."""
    (rays, excl, tris, tile_ids, block_ids, entry, count), kw = bounce_launch
    t = torch.from_numpy
    best_t, _ = tbsr.bsr_nearest_ref(*(t(a) for a in bounce_launch[0]),
                                     **kw)
    rng = np.random.default_rng(3)
    r = rays.shape[1]
    best_t = best_t.numpy()
    rays = rays.copy()
    rays[6] = np.where(np.isfinite(best_t),
                       best_t * rng.uniform(0.5, 1.5, r), tbsr.BIG_TMAX)
    init = (rng.uniform(size=r) < 0.1).astype(np.int32)
    return (rays, excl, tris, tile_ids, block_ids, entry, count, init), kw


@pytest.mark.parametrize("exit_every", [0, 8])
def test_bsr_any_rays_ref_matches_pallas(bounce_launch, exit_every):
    """K3a against the Pallas any-hit kernel with shared_origin=False."""
    args, kw = any_rays_inputs(bounce_launch)
    want = np.asarray(jbsr.bsr_any(
        *(jnp.asarray(a) for a in args), rt=RT, tb=kw["tb"],
        w_pad=len(args[3]), interpret=True, shared_origin=False,
        exit_every=exit_every))
    got = tbsr.bsr_any_ref(*(torch.from_numpy(a) for a in args),
                           **dict(kw, exit_every=exit_every)).numpy()
    rays, init = args[0], args[7]
    vis = visited(args[3], args[6], rays.shape[1])
    np.testing.assert_array_equal(got[vis], want[vis])
    bounded = vis & (rays[6] < tbsr.BIG_TMAX) & (init == 0)
    assert 0 < got[bounded].sum() < bounded.sum()  # some stop short
    np.testing.assert_array_equal(got[~vis], init[~vis])


@pytest.mark.parametrize("exit_every", [0, 8])
def test_bsr_any_ref_matches_pallas(launches, exit_every):
    (q, excl, tris, tile_ids, block_ids, entry, count, dead), kw = \
        launches["bsr_any"]
    n_tris = launches["arrays"].p0.shape[0]
    assert tris.shape[0] == 3 * n_tris                 # three lights' packs
    assert block_ids[:int(count)].max() >= n_tris // kw["tb"]
    want = np.asarray(jbsr.bsr_any(
        *(jnp.asarray(a) for a in (q, excl, tris, tile_ids, block_ids, entry,
                                   count, dead)),
        rt=RT, tb=kw["tb"], w_pad=len(tile_ids), interpret=True,
        shared_origin=True, exit_every=exit_every))
    got = tbsr.bsr_any_ref(
        *(torch.from_numpy(a) for a in (q, excl, tris, tile_ids, block_ids,
                                        entry, count, dead)),
        rt=RT, tb=kw["tb"], shared_origin=True, exit_every=exit_every).numpy()
    vis = visited(tile_ids, count, q.shape[1])
    np.testing.assert_array_equal(got[vis], want[vis])
    live_hits = got[vis][dead[vis] == 0]
    assert 0 < live_hits.sum() < live_hits.size    # some shadowed, some lit
    np.testing.assert_array_equal(got[~vis], dead[~vis])


def test_cpu_wrappers_use_plain_versions(launches):
    """On CPU tensors the wrappers compute the plain versions and launch
    nothing."""
    before = dict(tracing.COUNTS)
    args, kw = launches["bsr_nearest"]
    ta = [torch.from_numpy(a) for a in args]
    for got, want in zip(tbsr.bsr_nearest(*ta, **kw),
                         tbsr.bsr_nearest_ref(*ta, **kw)):
        assert torch.equal(got, want)
    args, kw = launches["bsr_any"]
    ta = [torch.from_numpy(a) for a in args]
    assert torch.equal(tbsr.bsr_any(*ta, **kw), tbsr.bsr_any_ref(*ta, **kw))
    assert tracing.COUNTS == before


def test_wrappers_refuse_what_the_kernels_do_not_take(launches):
    args, kw = launches["bsr_nearest"]
    ta = [torch.from_numpy(a) for a in args]
    with pytest.raises(ValueError, match="exit_every"):
        tbsr.bsr_nearest(*ta, **dict(kw, shared_origin=False, exit_every=-1))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tbsr.bsr_nearest(*(a.to("meta") for a in ta), **kw)
    with pytest.raises(ValueError, match="exclude"):
        tbsr.bsr_nearest(ta[0], ta[1].long(), *ta[2:], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tbsr.bsr_nearest(ta[0], ta[1], ta[2].T.contiguous().T, *ta[3:], **kw)
    with pytest.raises(ValueError, match="rt="):
        tbsr.bsr_nearest(*ta, **dict(kw, rt=384))
    with pytest.raises(ValueError, match="multiple of tb"):
        tbsr.bsr_nearest(*ta, **dict(kw, tb=kw["tb"] * 3 + 1))


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(launches):
    """On a card: both kernels, with and without the early exit, against
    their plain versions on the same CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    dev = torch.device("cuda")
    for name in ("bsr_nearest", "bsr_any"):
        args, kw = launches[name]
        ta = [torch.from_numpy(a).to(dev) for a in args]
        kernel, plain = getattr(tbsr, name), getattr(tbsr, name + "_ref")
        for exit_every in (0, 8):
            k = dict(kw, exit_every=exit_every)
            before = tracing.COUNTS[name]
            got, want = kernel(*ta, **k), plain(*ta, **k)
            assert tracing.COUNTS[name] == before + 1
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, exit_every)


@pytest.mark.cuda
def test_cuda_rays_kernels_match_plain_versions(bounce_launch):
    """On a card: the per-ray-origin kernels (K3n, K3a), with and without
    the early exit, against their plain versions on the same CUDA tensors,
    bit for bit (t compared as int32); they count as per-ray-origin
    launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    dev = torch.device("cuda")
    for name, (args, kw) in (("bsr_nearest", bounce_launch),
                             ("bsr_any", any_rays_inputs(bounce_launch))):
        ta = [torch.from_numpy(a).to(dev) for a in args]
        kernel, plain = getattr(tbsr, name), getattr(tbsr, name + "_ref")
        key = tbsr.launch_key(name, shared_origin=False)
        for exit_every in (0, 8):
            k = dict(kw, exit_every=exit_every)
            before = dict(tracing.COUNTS)
            got, want = kernel(*ta, **k), plain(*ta, **k)
            assert tracing.COUNTS == dict(before, **{key: before[key] + 1})
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for g, w in zip(got, want):
                if g.dtype == torch.float32:
                    g, w = g.view(torch.int32), w.view(torch.int32)
                assert torch.equal(g, w), (name, exit_every)

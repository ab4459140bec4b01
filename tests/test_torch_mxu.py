"""The tensor-core form of the PyTorch port's traversal (the JAX package's
"MXU" kernels K4 and K5: `pack_dirs`, `fold_origin_scal`, `bsr_nearest` /
`bsr_any` with an (A, scal) tuple, `CulledRenderer(use_mxu=True)`) against
the JAX package, whose Pallas kernels run here in interpret mode.

Inputs are the recorded launches of the port's CPU renderer under
use_mxu=True on icosphere_scene(3) at 64x48, baked once by the JAX package
(every work list far below the JAX kernels' 16,384-item segment), and the
four mirrored spheres instanced_grid(icosphere_scene(2), 2) at 64x48 for
whole frames. Tolerances:
  - pack_dirs: bit-equal. fold_origin_scal: bit-equal to the port's own
    pack_tris_origin scalars (both sum x, y, z in order); against JAX to
    1e-6 (XLA's CPU backend contracts the three-term sum into fused
    multiply-adds, so in-order rounding differs in the last bit), as the
    pack_tris_origin test in test_torch_bsr_trace.py;
  - plain K4/K5 against the Pallas kernels: ids and any-hit flags exactly
    equal on every ray of the visited tiles, t to 1e-6 relative (measured
    gap of the Pallas MXU kernel to its all-VPU twin: 4.3e-7);
  - plain K4 against plain K1 on the same launch: bit for bit (the three
    dots are elementwise in the same order);
  - whole frames: atol 2e-5 (the repository's bound for identical arrays),
    raw work counts exactly equal.
The CUDA kernels (3xTF32 on the tensor cores, not bit-equal) are held to
the plain versions by the `cuda`-marked test, on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops.pallas import bsr_trace as jbsr
from distributed_raytracer_tpu.ops.render_bvh import CulledRenderer as JaxRenderer
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.scene import from_reference
from distributed_raytracer_tpu_torch.ops import bsr_trace as tbsr
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.utils import trace_cases, tracing

RT = 512
W, H = 64, 48


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Runs the module's torch ops on one thread: under pytest-xdist every
    worker's torch would otherwise start a thread per core and the workers
    oversubscribe the machine (tests/test_torch_ring_chunks.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def launches():
    """{name: (args as numpy, kwargs)} of the port's use_mxu=True render()
    launches, plus the scene arrays."""
    scene = jscenes.icosphere_scene(3)
    arrays, tree = scene.bake_bvh(block_size=64)
    r = CulledRenderer(None, W, H, prebaked=from_reference(arrays, tree),
                       device="cpu", use_mxu=True)
    seen = {}
    originals = {n: getattr(tbsr, n) for n in ("bsr_nearest", "bsr_any")}

    def numpy(a):
        if isinstance(a, tuple):
            return tuple(numpy(x) for x in a)
        return a if a is None else a.numpy().copy()

    def recorder(name):
        def call(*args, **kwargs):
            kw = dict(kwargs)
            seen[name] = (tuple(numpy(a) for a in args),
                          numpy(kw.pop("ablock_ids", None)), kw)
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


def visited(tile_ids, count, r):
    v = np.zeros(r // RT, bool)
    v[tile_ids[:min(int(count), len(tile_ids))]] = True
    return np.repeat(v, RT)


def to_torch(a):
    if isinstance(a, tuple):
        return tuple(to_torch(x) for x in a)
    return None if a is None else torch.from_numpy(a)


def to_jax(a):
    if isinstance(a, tuple):
        return tuple(to_jax(x) for x in a)
    return None if a is None else jnp.asarray(a)


def test_pack_dirs_matches(launches):
    tris = jbsr.pack_tris(launches["arrays"])
    for tb in (16, 64):
        np.testing.assert_array_equal(tbsr.pack_dirs(tris, tb),
                                      jbsr.pack_dirs(tris, tb))
    with pytest.raises(ValueError, match="multiple of tb"):
        tbsr.pack_dirs(tris[:-1], 64)


def test_fold_origin_scal_matches(launches):
    tris = jbsr.pack_tris(launches["arrays"])
    rng = np.random.default_rng(11)
    for _ in range(3):
        origin = (rng.normal(size=3) * 3).astype(np.float32)
        got = tbsr.fold_origin_scal(torch.from_numpy(tris),
                                    torch.from_numpy(origin)).numpy()
        want = np.asarray(jbsr.fold_origin_scal(jnp.asarray(tris),
                                                jnp.asarray(origin)))
        assert got.shape == want.shape == (tris.shape[0], 8)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(got[:, 3:], 0.0)
        folded = tbsr.pack_tris_origin(torch.from_numpy(tris),
                                       torch.from_numpy(origin)).numpy()
        np.testing.assert_array_equal(got[:, :3], folded[:, [3, 7, 11]])


@pytest.mark.parametrize("exit_every", [0, 8])
def test_plain_k4_matches_pallas(launches, exit_every):
    args, ablock, kw = launches["bsr_nearest"]
    assert isinstance(args[2], tuple) and kw["shared_origin"] is True
    rays, tile_ids, count = args[0], args[3], args[6]
    assert int(count) <= 16384
    wt, wi = jbsr.bsr_nearest(
        *to_jax(args), ablock_ids=to_jax(ablock), rt=RT, tb=kw["tb"],
        w_pad=len(tile_ids), interpret=True, shared_origin=True,
        exit_every=exit_every)
    gt, gi = tbsr.bsr_nearest_ref(*to_torch(args), ablock_ids=to_torch(ablock),
                                  **dict(kw, exit_every=exit_every))
    vis = visited(tile_ids, count, rays.shape[1])
    wt, wi, gt, gi = (np.asarray(wt), np.asarray(wi), gt.numpy(), gi.numpy())
    np.testing.assert_array_equal(gi[vis], wi[vis])
    fin = np.isfinite(wt[vis])
    assert fin.sum() > 100                         # the frame has hits
    np.testing.assert_array_equal(np.isfinite(gt[vis]), fin)
    np.testing.assert_allclose(gt[vis][fin], wt[vis][fin], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(gt[~vis], np.inf)


@pytest.mark.parametrize("exit_every", [0, 8])
def test_plain_k5_matches_pallas(launches, exit_every):
    """The all-lights launch: block_ids carry the light offset into the
    stacked scalar rows, ablock_ids index the one shared A."""
    args, ablock, kw = launches["bsr_any"]
    q, tile_ids, block_ids, count, dead = (args[0], args[3], args[4],
                                           args[6], args[7])
    n_tris = launches["arrays"].p0.shape[0]
    dirs, scal = args[2]
    assert dirs.shape == (3 * n_tris, 8) and scal.shape == (3 * n_tris, 8)
    live = slice(0, int(count))
    assert (ablock[live] != block_ids[live]).any()
    np.testing.assert_array_equal(ablock[live],
                                  block_ids[live] % (n_tris // kw["tb"]))
    want = np.asarray(jbsr.bsr_any(
        *to_jax(args), ablock_ids=to_jax(ablock), rt=RT, tb=kw["tb"],
        w_pad=len(tile_ids), interpret=True, shared_origin=True,
        exit_every=exit_every))
    got = tbsr.bsr_any_ref(*to_torch(args), ablock_ids=to_torch(ablock),
                           **dict(kw, exit_every=exit_every)).numpy()
    vis = visited(tile_ids, count, q.shape[1])
    np.testing.assert_array_equal(got[vis], want[vis])
    live_hits = got[vis][dead[vis] == 0]
    assert 0 < live_hits.sum() < live_hits.size    # some shadowed, some lit
    np.testing.assert_array_equal(got[~vis], dead[~vis])


def test_plain_k4_equals_plain_k1(launches):
    """The same launch in the (T, 16) pack_tris_origin form: bit for bit."""
    args, ablock, kw = launches["bsr_nearest"]
    targs = to_torch(args)
    rays = targs[0]
    tris16 = torch.from_numpy(jbsr.pack_tris(launches["arrays"]))
    k1_args = (rays, targs[1], tbsr.pack_tris_origin(tris16, rays[0:3, 0])
               ) + targs[3:]
    k4 = tbsr.bsr_nearest_ref(*targs, ablock_ids=to_torch(ablock), **kw)
    k1 = tbsr.bsr_nearest_ref(*k1_args, **kw)
    assert torch.isfinite(k1[0]).sum() > 100
    for a, b in zip(k4, k1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("origins", [1, 2])
def test_plain_tuple_form_equals_rows_form_on_edge_cases(origins):
    """utils/trace_cases.edge_case_launch in the tensor-core form against
    the same launch in the (S, 16) pack_tris_origin form (K4 against K1, K5
    against K2 in plain PyTorch), with and without the second origin's
    scalars stacked over the one A: bit for bit, t as int32."""
    L = trace_cases.edge_case_launch(256, 64, mxu_origins=origins)
    dirs, scal = L.tris
    shared = trace_cases.edge_case_launch(256, 64)
    static = torch.from_numpy(tbsr.pack_tris(
        trace_cases._two_spheres().bake()))
    # A is the launch's rows' directions; ORIGIN's scalars are
    # fold_origin_scal's of the static rows, bit for bit.
    assert torch.equal(L.rows()[:shared.tris.shape[0]], shared.tris)
    assert torch.equal(
        scal[:static.shape[0], :3],
        tbsr.fold_origin_scal(static, torch.tensor(trace_cases.ORIGIN))[:, :3])
    n = int(L.count)
    differ = (L.ablock_ids != L.block_ids)[:n]
    assert bool(differ.any()) == (origins == 2)
    assert torch.equal(L.ablock_ids, L.block_ids % (dirs.shape[0] // 192))
    twin = L.twin()
    for name, args, targs in (("bsr_nearest", L.nearest_args(),
                               twin.nearest_args()),
                              ("bsr_any", L.any_args(), twin.any_args())):
        for exit_every in (0, 32):
            kw = dict(L.kwargs, exit_every=exit_every)
            got = getattr(tbsr, name + "_ref")(*args, **kw)
            want = getattr(tbsr, name + "_ref")(*targs, **kw)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            for a, b in zip(got, want):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    t, _ = tbsr.bsr_nearest_ref(*L.nearest_args(), **L.kwargs)
    hit = tbsr.bsr_any_ref(*L.any_args(), **L.kwargs)
    vis = L.visited()
    assert 0.2 < float(torch.isfinite(t[vis]).float().mean()) < 0.95
    assert 0 < int(hit[vis].sum()) < int(vis.sum())


def test_tuple_form_checks(launches):
    args, ablock, kw = launches["bsr_nearest"]
    ta = list(to_torch(args))
    dirs, scal = ta[2]
    before = dict(tracing.COUNTS)
    with pytest.raises(ValueError, match="shared origin"):
        tbsr.bsr_nearest(*ta, **dict(kw, shared_origin=False))
    with pytest.raises(ValueError, match="multiple of 16"):
        tbsr.bsr_nearest(*ta, **dict(kw, tb=8))
    with pytest.raises(ValueError, match="3\\*tb"):
        tbsr.bsr_nearest(*ta[:2], (dirs[:-1], scal), *ta[3:], **kw)
    with pytest.raises(ValueError, match="scal"):
        tbsr.bsr_nearest(*ta[:2], (dirs, scal[:, :4].contiguous()),
                         *ta[3:], **kw)
    with pytest.raises(ValueError, match="ablock_ids"):
        tbsr.bsr_nearest(*ta, ablock_ids=ta[4].long(), **kw)
    with pytest.raises(ValueError, match="only with the"):
        tbsr.bsr_nearest(*ta[:2], torch.zeros(scal.shape[0], 16), *ta[3:],
                         ablock_ids=ta[4], **kw)
    assert tracing.COUNTS == before
    assert tbsr.launch_key("bsr_any", True, mxu=True) == "bsr_any_mxu"


@pytest.fixture(scope="module")
def grid_pair():
    scene = jscenes.instanced_grid(jscenes.icosphere_scene(2), 2)
    bake = scene.bake_bvh(block_size=64)
    return (scene,
            JaxRenderer(None, W, H, interpret=True, prebaked=bake,
                        use_mxu=True),
            CulledRenderer(None, W, H, prebaked=from_reference(*bake),
                           device="cpu", use_mxu=True))


def test_render_and_render_fast_match_jax(grid_pair):
    scene, jr, tr = grid_pair
    cam = scene.camera.yaw(0.05)
    want = np.asarray(jr.render(cam.to_arrays()))
    before = dict(tracing.COUNTS)
    got = tr.render(cam).numpy()
    assert tracing.COUNTS == before               # plain versions on the CPU
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert tr._last_counts == jr._last_counts
    assert (got.sum(-1) > 0).mean() > 0.05
    tr.freeze(cam)
    fast = tr.render_fast(cam, verify=True).numpy()
    np.testing.assert_allclose(fast, got, atol=2e-5, rtol=0)
    assert all(c <= p for c, p in zip(tr._last_counts, tr.buckets()))


def test_render_bounced_matches_jax(grid_pair):
    """Depth 1: the nearest queries stay per-ray-origin (K3n), every shadow
    query runs the tensor-core any-hit form (K5), as in JAX."""
    scene, jr, tr = grid_pair
    want = np.asarray(jr.render_bounced(scene.camera.to_arrays(), depth=1))
    got = tr.render_bounced(scene.camera, 1).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert tr._last_bounce_counts == jr._last_bounce_counts
    assert tr._last_bounce_counts[1][tr.n_levels] > 0
    plain = CulledRenderer(None, W, H, prebaked=(tr.arrays_host, tr.tree),
                           device="cpu")
    np.testing.assert_allclose(got, plain.render_bounced(scene.camera,
                                                         1).numpy(),
                               atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_cuda_mxu_kernels_match_plain_versions(launches):
    """On a card: K4 and K5, with and without the early exit, against their
    plain versions on the same CUDA tensors (3xTF32 on the tensor cores:
    ids and flags equal on all but a few edge ties, t to 1e-5 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    dev = torch.device("cuda")

    def cuda(a):
        if isinstance(a, tuple):
            return tuple(cuda(x) for x in a)
        return torch.from_numpy(a).to(dev)

    for name in ("bsr_nearest", "bsr_any"):
        args, ablock, kw = launches[name]
        ta, ab = cuda(args), cuda(ablock)
        kernel, plain = getattr(tbsr, name), getattr(tbsr, name + "_ref")
        key = tbsr.launch_key(name, True, mxu=True)
        for exit_every in (0, 8):
            k = dict(kw, exit_every=exit_every)
            before = dict(tracing.COUNTS)
            got = kernel(*ta, ablock_ids=ab, **k)
            want = plain(*ta, ablock_ids=ab, **k)
            assert tracing.COUNTS == dict(before, **{key: before[key] + 1})
            if name == "bsr_any":
                assert int((got != want).sum()) <= 2
                continue
            (gt, gi), (pt, pi) = got, want
            hits = torch.isfinite(pt)
            assert torch.equal(torch.isfinite(gt), hits)
            assert int((gi != pi)[hits].sum()) <= 2
            same = hits & (gi == pi)
            rel = ((gt - pt).abs() / pt.abs())[same]
            assert float(rel.max()) <= 1e-5


@pytest.mark.cuda
def test_cuda_mxu_kernels_on_tuple_edge_cases():
    """On a card: K4 and K5 on the tuple-form edge cases (one origin, two
    origins' scalars over one A) at rt 256 and 512, with and without the
    front-to-back skip: on the visited rays that trace_cases.ambiguous_rays
    does not set aside (their result rests on a BARY_EPS bound, a t tie,
    t_max or a grazing den to within the 3xTF32 dots' error), ids, hits
    and flags equal the plain versions' and t agrees to 1e-5 relative;
    unvisited tiles keep init."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    for rt in (256, 512):
        for origins in (1, 2):
            host = trace_cases.edge_case_launch(rt, 64, mxu_origins=origins)
            near, any_hit = trace_cases.ambiguous_rays(host, dot_ulps=8)
            L = host.to("cuda")
            vis = L.visited().cpu()
            assert int((near & vis).sum()) <= 0.4 * int(vis.sum())
            for exit_every in (0, 32):
                kw = dict(L.kwargs, exit_every=exit_every)
                gt, gi = (x.cpu() for x in tbsr.bsr_nearest(
                    *L.nearest_args(), **kw))
                pt, pi = (x.cpu() for x in tbsr.bsr_nearest_ref(
                    *L.nearest_args(), **kw))
                ga = tbsr.bsr_any(*L.any_args(), **kw).cpu()
                pa = tbsr.bsr_any_ref(*L.any_args(), **kw).cpu()
                keep = vis & ~near
                assert torch.equal(gi[keep], pi[keep])
                hits = keep & torch.isfinite(pt)
                assert torch.equal(torch.isfinite(gt[keep]),
                                   torch.isfinite(pt[keep]))
                rel = ((gt - pt).abs() / pt.abs().clamp_min(1e-30))[hits]
                assert float(rel.max()) <= 1e-5
                assert torch.equal(ga[vis & ~any_hit], pa[vis & ~any_hit])
                assert torch.equal(gi[~vis], pi[~vis])
                assert torch.equal(ga[~vis], pa[~vis])

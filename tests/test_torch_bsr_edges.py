"""The traversal on hard inputs (utils/trace_cases) in both origin forms:
rays aimed exactly at shared vertices and edges, grazing rays, dead rays,
zero padding rows, ties, t = -0.0, exclusion, finite seeds, t_max at the
hit; per ray, origins spread about the eye and on the spheres' surfaces,
each of those excluding its own triangle.

On the CPU the port's plain versions (bsr_nearest_ref, bsr_any_ref) are
held against the JAX package's Pallas kernels in interpret mode, as
tests/test_torch_bsr_trace.py runs them. XLA's CPU backend contracts the
pair math's sums into fused multiply-adds, so on these inputs its t, u and
v may differ from the port's in the last bits. The test finds the rays
where that can change a result, from the port's own pair math over each
ray's live items, counts them and bounds them:
  - a pair with a barycentric (u, v or u + v) within 1e-6 of a BARY_EPS
    bound, no farther than the ray's nearest hit (any hit: its t_max);
  - two candidates (triangles, or a triangle and the init seed) whose t
    agree to rtol 1e-6 at the ray's nearest hit; any hit: a valid pair
    whose t agrees with t_max to rtol 1e-6;
  - a grazing hit no farther than that, whose den = n.d cancels so far
    (sum |n_i d_i| > 2^23 * 1e-6 |den|) that t itself is uncertain beyond
    rtol 1e-6.
With per-ray origins the origin dots are summed inside the pair math too,
so the finder also counts a numerator w - n.o that cancels as den does,
and widens the barycentric band by ORIGIN_ULPS ulps of the origin dots'
terms (sum |k_i o_i|).
On every other ray of the visited tiles, ids and any-hit flags must be
equal and t must agree to rtol 1e-6. Every list holds far fewer than the
16,384 items past which the JAX reference loses results; the per-ray
launches stay at rt = 256 (8 tiles) to keep the interpret-mode runs short.

On a card (`cuda` marker), K1, K2, K3n and K3a must equal the plain
versions bit for bit on the same inputs at every ray tile and triangle
block they take.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops.pallas import bsr_trace as jbsr
from distributed_raytracer_tpu_torch.ops import bsr_trace as tbsr
from distributed_raytracer_tpu_torch.utils import trace_cases, tracing

EPS = tbsr.BARY_EPS
RTOL = 1e-6
# At most this share of the visited rays may be set aside: the launch aims
# about half its rays at vertices and edges on purpose.
AMBIGUOUS_SHARE = 0.4
# Ulps of the origin dots' terms by which FMA contraction may move a
# per-ray u or v (a few roundings, each up to half an ulp of a term).
ORIGIN_ULPS = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Runs the module's torch ops on one thread: under pytest-xdist every
    worker's torch would otherwise start a thread per core and the workers
    oversubscribe the machine (tests/test_torch_ring_chunks.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def ambiguous(L):
    """((R,) bool for the nearest query, (R,) bool for the any-hit query):
    rays whose result may differ under fused multiply-adds
    (utils/trace_cases.ambiguous_rays)."""
    return trace_cases.ambiguous_rays(L, rtol=RTOL, origin_ulps=ORIGIN_ULPS)


def check_against_pallas(L, exit_every):
    """The plain versions against the Pallas kernels in interpret mode on
    one launch, ambiguous rays set aside; returns the set-aside shares
    (nearest, any hit) of the visited rays."""
    n = int(L.count)

    def j(a):
        if isinstance(a, tuple):
            return tuple(j(x) for x in a)
        return jnp.asarray(a.numpy())

    common = (j(L.rays), j(L.exclude), j(L.tris), j(L.tile_ids),
              j(L.block_ids), j(L.entry), jnp.int32(n))
    static = dict(L.kwargs, w_pad=len(L.tile_ids), interpret=True,
                  exit_every=exit_every)
    if L.ablock_ids is not None:
        static["ablock_ids"] = j(L.ablock_ids)
    wt, wi = jbsr.bsr_nearest(*common, j(L.init_t), j(L.init_i),
                              jnp.int32(int(L.gid_base)), **static)
    wa = jbsr.bsr_any(*common, j(L.init_hit), jnp.int32(int(L.gid_base)),
                      **static)
    kw = dict(L.kwargs, exit_every=exit_every)
    gt, gi = tbsr.bsr_nearest_ref(*L.nearest_args(), **kw)
    ga = tbsr.bsr_any_ref(*L.any_args(), **kw)
    wt, wi, wa = np.asarray(wt), np.asarray(wi), np.asarray(wa)
    gt, gi, ga = gt.numpy(), gi.numpy(), ga.numpy()

    vis = L.visited().numpy()
    near, any_hit = (a.numpy() for a in ambiguous(L))
    n_vis = vis.sum()
    shares = []
    for name, amb in (("nearest", near), ("any hit", any_hit)):
        print(f"{name}: {(amb & vis).sum()} of {n_vis} visited rays set "
              "aside")
        assert (amb & vis).sum() <= AMBIGUOUS_SHARE * n_vis, name
        shares.append((amb & vis).sum() / n_vis)
    keep = vis & ~near
    np.testing.assert_array_equal(gi[keep], wi[keep])
    fin = np.isfinite(wt[keep])
    np.testing.assert_array_equal(np.isfinite(gt[keep]), fin)
    np.testing.assert_allclose(gt[keep][fin], wt[keep][fin], rtol=RTOL,
                               atol=0)
    keep = vis & ~any_hit
    np.testing.assert_array_equal(ga[keep], wa[keep])
    # The inputs do hit, miss and shadow.
    assert 0.2 < fin.mean() < 0.95
    assert 0 < ga[keep].sum() < keep.sum()
    return shares


@pytest.mark.parametrize("exit_every", [0, 32])
@pytest.mark.parametrize("rt,tb", [(256, 64), (512, 128)])
def test_edge_cases_match_pallas(rt, tb, exit_every):
    check_against_pallas(trace_cases.edge_case_launch(rt, tb), exit_every)


@pytest.mark.parametrize("exit_every", [0, 32])
@pytest.mark.parametrize("tb", [64, 128])
def test_per_ray_edge_cases_match_pallas(tb, exit_every):
    """K3n/K3a's plain versions (per-ray origins, static rows) against the
    Pallas kernels with shared_origin=False."""
    L = trace_cases.edge_case_launch(256, tb, shared_origin=False)
    check_against_pallas(L, exit_every)


@pytest.mark.parametrize("origins,exit_every", [(1, 0), (2, 32)])
def test_tuple_form_edge_cases_match_pallas_mxu(origins, exit_every):
    """K4/K5's plain versions on the tensor-core tuple (A, scal) with
    ablock_ids against the Pallas _nearest_mxu_kernel / _any_mxu_kernel in
    interpret mode, whose three dots are one HIGHEST-precision product: one
    origin, and two origins' scalars stacked over one A (every other live
    item reads the second's). A small launch (rt 128, 8 tiles); ambiguous
    rays set aside and their share bounded as above."""
    L = trace_cases.edge_case_launch(128, 64, mxu_origins=origins)
    assert isinstance(L.tris, tuple)
    shares = check_against_pallas(L, exit_every)
    assert max(shares) <= AMBIGUOUS_SHARE


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions_on_edge_cases():
    """On a card: K1 and K2 (shared origin) and K3n and K3a (per-ray
    origins) equal their plain versions bit for bit, with and without the
    front-to-back skip, at every rt and tb; one count each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    for rt, tb, shared in itertools.product((256, 512, 1024), (64, 128),
                                            (True, False)):
        L = trace_cases.edge_case_launch(rt, tb,
                                         shared_origin=shared).to("cuda")
        near = tbsr.launch_key("bsr_nearest", shared)
        any_key = tbsr.launch_key("bsr_any", shared)
        for exit_every in (0, 32):
            kw = dict(L.kwargs, exit_every=exit_every)
            before = dict(tracing.COUNTS)
            gt, gi = tbsr.bsr_nearest(*L.nearest_args(), **kw)
            ga = tbsr.bsr_any(*L.any_args(), **kw)
            assert tracing.COUNTS == dict(before, **{
                near: before[near] + 1, any_key: before[any_key] + 1})
            wt, wi = tbsr.bsr_nearest_ref(*L.nearest_args(), **kw)
            wa = tbsr.bsr_any_ref(*L.any_args(), **kw)
            torch.cuda.synchronize()
            case = (rt, tb, shared, exit_every)
            assert torch.equal(gt.view(torch.int32),
                               wt.view(torch.int32)), case
            assert torch.equal(gi, wi), case
            assert torch.equal(ga, wa), case

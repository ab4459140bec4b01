"""The premise of the traversal kernels' chunk grid (csrc/bsr_trace.cu: K1
and K2 with a shared origin, K3n and K3a with per-ray origins, K4 and K5 in
the tensor-core form), tested with the plain versions on the CPU in every
triangle form.

The kernels split the work list into consecutive chunks of C items, fold
each chunk on its own and merge the chunks into the result: nearest hits by
the minimum of the int64 key (bits(t + 0.0) << 32) | id, seeded from init;
any-hit flags by OR over init. The merge is order-free, so it must equal
the whole list's result bit for bit whatever C is. The inputs are
utils/trace_cases.edge_case_launch's: ties between two ids at one t, hits
at t = -0.0, tiles without items (which keep init), chunks that straddle
tiles, slots past count; per ray, origins on the spheres' surfaces that
exclude their own triangle; in the tensor-core form (A, scal) with
ablock_ids, for one origin and for two origins' scalars stacked over one A
(every other live item reads the second origin's).
"""

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu_torch.ops import bsr_trace as tbsr
from distributed_raytracer_tpu_torch.utils import trace_cases

RT, TB = 256, 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Runs the module's torch ops on one thread: under pytest-xdist every
    worker's torch would otherwise start a thread per core and the workers
    oversubscribe the machine (tests/test_torch_ring_chunks.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FORMS = {"shared": dict(shared_origin=True),
         "per_ray": dict(shared_origin=False),
         "mxu": dict(mxu_origins=1),
         "mxu_two_origins": dict(mxu_origins=2)}


@pytest.fixture(scope="module", params=["shared", "per_ray"])
def launch(request):
    return trace_cases.edge_case_launch(RT, TB, chunk=8,
                                        **FORMS[request.param])


@pytest.fixture(scope="module", params=list(FORMS))
def any_form(request):
    """The launch in every triangle form, the tensor-core tuple's too."""
    return trace_cases.edge_case_launch(RT, TB, chunk=8,
                                        **FORMS[request.param])


def chunk_args(L, s, e):
    """The launch's work list cut to the items [s, e), with default
    init, and its ablock_ids as a keyword ({} outside the tuple form)."""
    kw = ({} if L.ablock_ids is None
          else {"ablock_ids": L.ablock_ids[s:e].contiguous()})
    return (L.rays, L.exclude, L.tris, L.tile_ids[s:e].contiguous(),
            L.block_ids[s:e].contiguous(), L.entry[s:e].contiguous()), kw


def unpack(keys):
    t = (keys >> 32).to(torch.int32).view(torch.float32)
    return t, (keys & 0xFFFFFFFF).to(torch.int32)


@pytest.mark.parametrize("query", ["nearest", "any"])
@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_chunk_merge_equals_whole_list(any_form, chunk, query):
    L = any_form
    n = int(L.count)
    starts = range(0, n, chunk)
    assert any(len(set(L.tile_ids[s:s + chunk].tolist())) > 1
               for s in starts) or chunk == 1      # chunks straddle tiles
    if query == "nearest":
        whole_t, whole_i = tbsr.bsr_nearest_ref(*L.nearest_args(),
                                                **L.kwargs)
        merged = tbsr._keys(L.init_t, L.init_i)
        for s in starts:
            args, kw = chunk_args(L, s, min(s + chunk, n))
            t, i = tbsr.bsr_nearest_ref(*args, gid_base=L.gid_base, **kw,
                                        **L.kwargs)
            merged = torch.minimum(merged, tbsr._keys(t, i))
        got_t, got_i = unpack(merged)
        assert torch.equal(got_t.view(torch.int32),
                           whole_t.view(torch.int32))
        assert torch.equal(got_i, whole_i)
    else:
        whole = tbsr.bsr_any_ref(*L.any_args(), **L.kwargs)
        merged = L.init_hit.clone()
        for s in starts:
            args, kw = chunk_args(L, s, min(s + chunk, n))
            merged |= tbsr.bsr_any_ref(*args, gid_base=L.gid_base, **kw,
                                       **L.kwargs)
        assert torch.equal(merged, whole)


def test_edge_case_launch_holds_its_cases(launch):
    """The cases the merge test relies on are really in the inputs."""
    L = launch
    n = int(L.count)
    t_ids, b_ids = L.tile_ids.numpy(), L.block_ids.numpy()
    per_tile = np.bincount(t_ids[:n], minlength=trace_cases.N_TILES)
    assert (per_tile == 0).sum() >= 2 and (per_tile == 1).any()
    assert per_tile.max() > 4 * 8                   # more than 4 chunks of 8
    assert len(t_ids) > n and set(t_ids[n:]) <= {1, 5}
    best_t, best_i = tbsr.bsr_nearest_ref(*L.nearest_args(), **L.kwargs)
    vis = L.visited()
    # Tiles without items keep init (-0.0 would come back as +0.0).
    assert torch.equal(best_t[~vis], L.init_t[~vis] + 0.0)
    assert torch.equal(best_i[~vis], L.init_i[~vis])
    # Hits at t = -0.0 (the origin-plane block, d_z < 0) and at +0.0.
    plane = L.tris.shape[0] // TB - 2
    shared = L.kwargs["shared_origin"]
    t, valid, _, ray = tbsr._pairs(L.rays, L.exclude, L.tris,
                                   torch.tensor([6]), torch.tensor([plane]),
                                   torch.tensor([plane]), L.gid_base.long(),
                                   RT, TB, shared)
    zero = valid & (t == 0)
    assert (zero & torch.signbit(t)).any() and (zero & ~torch.signbit(t)).any()
    if not shared:
        # Origins differ, and a share of them sit within the lift of
        # `_reflect_from` above the triangle they exclude.
        assert L.rays[0:3].unique(dim=1).shape[1] > L.rays.shape[1] // 2
        n_tris = (plane - 1) * TB                # the scene's rows
        own = L.exclude.long() - int(L.gid_base)
        mine = (own >= 0) & (own < n_tris)
        row = L.tris[own[mine]]
        o = L.rays[0:3, mine].T
        gap = ((row[:, 0:3] * o).sum(1) - row[:, 3]).abs() / row[:, 0:3].norm(
            dim=1)
        assert int((gap <= 2e-3).sum()) > L.rays.shape[1] // 5
    # Ties: the copied block's hits equal the original's to the bit.
    dup = plane - 1
    src = np.nonzero((L.tris[dup * TB:(dup + 1) * TB] ==
                      L.tris[:dup * TB].reshape(dup, TB, 16)).all(-1).all(-1)
                     .numpy())[0]
    assert len(src) == 1
    tt, vv, _, _ = tbsr._pairs(L.rays, torch.full_like(L.exclude, -1),
                               L.tris, torch.tensor([2, 2]),
                               torch.tensor([int(src[0]), dup]),
                               torch.tensor([int(src[0]), dup]),
                               L.gid_base.long(), RT, TB, shared)
    assert vv[0].any() and torch.equal(torch.where(vv[0], tt[0], 0.0),
                                       torch.where(vv[1], tt[1], 0.0))
    # The heavy tile lists the copy first; where a ray does not exclude the
    # original, the original's lower id wins the tie.
    heavy = slice(2 * RT, 3 * RT)
    base = int(L.gid_base)
    won = best_i[heavy] - base
    excl = L.exclude[heavy] - base
    in_src = lambda x: (x >= src[0] * TB) & (x < (src[0] + 1) * TB)
    in_dup = (won >= dup * TB) & (won < (dup + 1) * TB)
    assert in_src(won).any()
    assert not (in_dup & ~in_src(excl)).any()

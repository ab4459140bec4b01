"""The premises of the ring step kernels' chunk grid (csrc/ring_trace.cu:
K6 and K7), on the CPU with the plain versions; JAX-free.

  (a) Each ring step's dense space of (ray tile, 128-row block) items, cut
      into chunks of 1, 3 and 8 items, each chunk folded from (inf,
      BIG_IDX) as a block folds it in registers and merged into ONE int64
      key scratch per rank (seeded once) by key minimum across chunks and
      steps, equals ring_nearest_ref bit for bit (t compared as int32);
      the chunks' flags OR-merged into one flag tensor per rank equal
      ring_any_ref.
  (b) Where every ray shares one origin, the shared-origin plain step on
      pack_tris_origin(slot, origin) rows equals the per-ray plain step on
      the slot's static rows bit for bit: the fold K6 makes in shared
      memory changes no bit.
  (c) A ray that hits nothing ends at (inf, 0), and a tie at one t goes to
      the lowest global id, in every order of visiting the shards.

Inputs, over [cpu] * n ranks, n in 1, 2, 4: the 64x48 frame of
utils/scenes.icosphere_scene(2) (its triangles padded as the kernel
transport pads them), and utils/trace_cases.ring_edge_case (ties between
two ids at one t, hits at t = +-0.0, exclusion, misses, dead rays) in both
origin forms.
"""

import itertools

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu_torch.ops import bsr_trace, raygen, ring_trace
from distributed_raytracer_tpu_torch.parallel import mesh
from distributed_raytracer_tpu_torch.utils import scenes, trace_cases

W, H = 64, 48
RT = 128
TB = ring_trace.TB
INF = float("inf")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Runs the module's torch ops on one thread. Under pytest-xdist every
    worker's torch would otherwise start a thread per core: six copies of
    this module at once on an 8-core machine took 788 s each, against 9 s
    for one copy alone and 17-20 s each with one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pad_rows(tris: torch.Tensor, multiple: int) -> torch.Tensor:
    out = torch.zeros((-(-tris.shape[0] // multiple) * multiple, 16))
    out[:tris.shape[0]] = tris
    return out


@pytest.fixture(scope="module")
def frame():
    """(rays (8, R), tris (T, 16), exclude (R,)): the frame's primary
    rays, its triangles padded to a multiple of 4 * 128."""
    scene = scenes.icosphere_scene(2)
    cam = raygen.camera_arrays(scene.camera, "cpu")
    dirs = raygen.ray_directions_flat(cam, W, H,
                                      torch.arange(W * H, dtype=torch.int32))
    rays = bsr_trace.pack_rays(cam.pos, dirs).contiguous()
    tris = pad_rows(torch.from_numpy(bsr_trace.pack_tris(scene.bake())),
                    4 * TB)
    return rays, tris, torch.full((W * H,), -1, dtype=torch.int32)


@pytest.fixture(scope="module")
def edges():
    return {shared: trace_cases.ring_edge_case(4, RT, shared_origin=shared)
            for shared in (False, True)}


CASES = ["frame", "edges per-ray", "edges one origin"]


def inputs(case, frame, edges):
    return frame if case == "frame" else edges[case.endswith("origin")]


def split(x, n, dim):
    return [p.contiguous() for p in torch.chunk(x, n, dim=dim)]


def ranks_of(rays, tris, excl, n):
    return (mesh.Ranks(mesh.make_mesh(n, "cpu")), split(rays, n, 1),
            split(tris, n, 0), split(excl, n, 0))


def step_items(ray, excl, slot, gid_base):
    """One rank's ring step as the kernel indexes it, every (ray tile,
    128-row block) item tile-major: (tile ids (W,), per item and ray the
    plain version's (t, gid) key minimum over the item's rows (W, RT), and
    whether some row is hit within t_max (W, RT) int32)."""
    t_ids, b_ids, _, base = ring_trace._dense_worklist(ray, slot, gid_base,
                                                       RT)
    t_ids, b_ids = t_ids.long(), b_ids.long()
    t, valid, gid, rows = bsr_trace._pairs(ray, excl, slot, t_ids, b_ids,
                                           b_ids, base.long(), RT, TB, False)
    keys = bsr_trace._keys(torch.where(valid, t, INF),
                           gid.expand_as(t)).amin(dim=1)
    hits = (valid & (t <= rows[6])).any(dim=1).to(torch.int32)
    return t_ids, keys, hits


def chunk_merge(t_ids, item, chunk: int, nt: int, seed, reduce: str):
    """The blocks of one step launch, `chunk` items each: each block folds
    its rays over its items from `seed` (per tile run, as in registers),
    then the blocks merge into one (nt, RT) result by `reduce` ("amin":
    the keys' atomicMin; "amax": stores of 1)."""
    w = t_ids.shape[0]
    run = (torch.arange(w) // chunk) * nt + t_ids       # (block, tile)
    out = seed.expand(-(-w // chunk) * nt, RT).clone()
    out.scatter_reduce_(0, run[:, None].expand_as(item), item, reduce)
    out = out.reshape(-1, nt, RT)
    return out.amin(dim=0) if reduce == "amin" else out.amax(dim=0)


def seed_key() -> torch.Tensor:
    return bsr_trace._keys(torch.full((1,), INF),
                           torch.full((1,), bsr_trace.BIG_IDX,
                                      dtype=torch.int32))


def unpack(keys):
    keys = keys.reshape(-1)
    return ((keys >> 32).to(torch.int32).view(torch.float32),
            (keys & 0xFFFFFFFF).to(torch.int32))


def bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def assert_bits_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(bits(g), bits(w))


@pytest.fixture(scope="module")
def ring(frame, edges):
    """Per (case, n), computed once: the split inputs (the frame's any-hit
    query with a shadow-like t_max, the nearest hit's t scaled by 0.5-1.5),
    ring_nearest_ref's and ring_any_ref's outputs, and every (rank,
    shard) step's items."""
    cache = {}

    def get(case, n):
        if (case, n) in cache:
            return cache[case, n]
        ranks, rays, tris, excl = ranks_of(*inputs(case, frame, edges), n)
        near = ring_trace.ring_nearest_ref(ranks, rays, tris, excl, rt=RT)
        shadow = rays
        if case == "frame":
            best_t = torch.cat(near[0])
            scale = np.random.default_rng(3).uniform(0.5, 1.5,
                                                     best_t.shape[0])
            shadow = split(torch.cat(rays, 1).clone(), n, 1)
            t_max = torch.where(torch.isfinite(best_t),
                                best_t * torch.from_numpy(scale).float(), INF)
            for r, part in zip(shadow, split(t_max, n, 0)):
                r[6] = part
        t_loc = tris[0].shape[0]
        steps = {(r, o): (step_items(rays[r], excl[r], tris[o], o * t_loc),
                          step_items(shadow[r], excl[r], tris[o],
                                     o * t_loc))
                 for r in range(n) for o in range(n)}
        cache[case, n] = dict(
            n=n, near=near, steps=steps,
            any=ring_trace.ring_any_ref(ranks, shadow, tris, excl, rt=RT))
        return cache[case, n]

    return get


def chunked_nearest(q, chunk: int, order=None):
    """K6's merge, per rank: one key scratch seeded once with (inf,
    BIG_IDX); every step's blocks merged into it by key minimum; unpacked
    once. `order` (default the rotation's, r, r - 1, ...) is the order in
    which every rank visits the shards."""
    n, out = q["n"], []
    for r in range(n):
        keys = None
        for o in order or [(r - s) % n for s in range(n)]:
            t_ids, item, _ = q["steps"][r, o][0]
            nt = int(t_ids.max()) + 1
            if keys is None:
                keys = seed_key().expand(nt, RT)
            keys = torch.minimum(keys, chunk_merge(t_ids, item, chunk, nt,
                                                   seed_key(), "amin"))
        out.append(unpack(keys))
    return [t for t, _ in out], [i for _, i in out]


def chunked_any(q, chunk: int):
    """K7's merge, per rank: one flag tensor zeroed once; every step's
    blocks store their hits into it."""
    n, out = q["n"], []
    for r in range(n):
        flags = None
        for o in ((r - s) % n for s in range(n)):
            t_ids, _, item = q["steps"][r, o][1]
            nt = int(t_ids.max()) + 1
            zero = torch.zeros((1,), dtype=torch.int32)
            flags = zero.expand(nt, RT) if flags is None else flags
            flags = torch.maximum(flags, chunk_merge(t_ids, item, chunk, nt,
                                                     zero, "amax"))
        out.append(flags.reshape(-1))
    return out


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("case", CASES)
def test_chunk_key_merge_equals_ring_nearest_ref(ring, case, n, chunk):
    q = ring(case, n)
    want_t, want_i = q["near"]
    got_t, got_i = chunked_nearest(q, chunk)
    assert_bits_equal(got_t, want_t)
    assert_bits_equal(got_i, want_i)
    assert torch.isfinite(torch.cat(want_t)).any()


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("case", CASES)
def test_chunk_flag_merge_equals_ring_any_ref(ring, case, n, chunk):
    q = ring(case, n)
    assert_bits_equal(chunked_any(q, chunk), q["any"])
    flags = torch.cat(q["any"])
    assert 0 < int(flags.sum()) < flags.shape[0]


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("case", ["frame", "edges one origin"])
def test_folded_rows_equal_per_ray_rows(frame, edges, case, n):
    rays, tris, excl = inputs(case, frame, edges)
    origin = rays[0:3, 0]
    assert torch.equal(bits(rays[0:3]), bits(origin[:, None]).expand(
        3, rays.shape[1]))
    t_loc = tris.shape[0] // n
    for o, slot in enumerate(split(tris, n, 0)):
        folded = bsr_trace.pack_tris_origin(slot, origin)
        t_ids, b_ids, w, base = ring_trace._dense_worklist(rays, slot,
                                                           o * t_loc, RT)
        seed_t = torch.full((rays.shape[1],), INF)
        seed_i = torch.full((rays.shape[1],), bsr_trace.BIG_IDX,
                            dtype=torch.int32)
        zero = torch.zeros((rays.shape[1],), dtype=torch.int32)
        near = [bsr_trace._nearest_ref(rays, excl, rows, t_ids, b_ids, b_ids,
                                       w, seed_t, seed_i, base, RT, TB,
                                       shared)
                for rows, shared in ((slot, False), (folded, True))]
        assert_bits_equal(near[1], near[0])
        hit = [bsr_trace._any_ref(rays, excl, rows, t_ids, b_ids, b_ids, w,
                                  zero, base, RT, TB, shared)
               for rows, shared in ((slot, False), (folded, True))]
        assert torch.equal(hit[1], hit[0])


def brute_nearest(rays, tris, excl):
    """Per ray (least t over every valid pair, the lowest global id at that
    t (0 for a miss), the number of ids at that t): every triangle at
    once."""
    t_ids, b_ids, _, _ = ring_trace._dense_worklist(rays, tris, 0, RT)
    t, valid, gid, _ = bsr_trace._pairs(rays, excl, tris, t_ids.long(),
                                        b_ids.long(), b_ids.long(),
                                        torch.zeros((1,), dtype=torch.long),
                                        RT, TB, False)
    nt, nb = rays.shape[1] // RT, tris.shape[0] // TB
    cand = torch.where(valid, t, INF).reshape(nt, nb * TB, RT)
    gid = gid.expand(-1, -1, RT).reshape(nt, nb * TB, RT)
    best = cand.amin(dim=1, keepdim=True)
    at = (cand == best) & torch.isfinite(best)
    low = torch.where(at, gid, torch.iinfo(torch.int64).max).amin(dim=1)
    low = torch.where(torch.isfinite(best[:, 0]), low, 0)
    return best.reshape(-1), low.reshape(-1), at.sum(dim=1).reshape(-1)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("case", CASES)
def test_miss_and_tie_rules_in_every_shard_order(frame, edges, ring, case,
                                                 n):
    q = ring(case, n)
    want_t, want_i = q["near"]
    best, low, ties = brute_nearest(*inputs(case, frame, edges))
    t, i = torch.cat(want_t), torch.cat(want_i)
    assert torch.equal(t, best)
    assert torch.equal(i, low.to(torch.int32))
    assert (i[~torch.isfinite(t)] == 0).all()
    if case.startswith("edges"):
        assert (ties > 1).any() and (~torch.isfinite(t)).any()
    # Each rank's steps merged into its seeded scratch in every order.
    for order in itertools.permutations(range(n)):
        got_t, got_i = chunked_nearest(q, 1 << 20, order=list(order))
        assert_bits_equal(got_t, want_t)
        assert_bits_equal(got_i, want_i)

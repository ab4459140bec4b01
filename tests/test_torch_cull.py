"""The PyTorch port's ray generation and culling against the JAX package's.

Both sides get the same inputs (numpy, from a seeded generator or from the
JAX package's own ray generation). Integer results — masks, counts, work
list tile and block ids — must be exactly equal; entry distances agree to
1e-6 relative (the interval math is elementwise f32 on both sides, so they
are in fact expected to be equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops import cull as jcull
from distributed_raytracer_tpu.ops import raygen as jraygen
from distributed_raytracer_tpu.ops.pallas import bsr_trace as jbsr
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.models.camera import CameraArrays
from distributed_raytracer_tpu_torch.ops import cull as tcull
from distributed_raytracer_tpu_torch.ops import raygen as traygen

W, H, RT = 64, 48, 512


def to_t(x):
    return torch.from_numpy(np.array(x))


def tcam(cam):
    return CameraArrays(*(torch.from_numpy(np.asarray(f, np.float32).copy())
                          for f in cam))


def jti(ti):
    return jcull.TileIntervals(*(jnp.asarray(np.asarray(f)) for f in ti))


def tti(ti):
    return tcull.TileIntervals(*(to_t(f) for f in ti))


def assert_entry_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)


def assert_worklist_equal(got, want):
    for f in ("tile_ids", "block_ids"):
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == np.int32 and w.dtype == np.int32
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert int(got.count) == int(want.count)
    assert_entry_close(got.entry.numpy(), want.entry)


@pytest.fixture(scope="module")
def setup():
    """icosphere_scene(3) baked with 64-triangle leaves, its primary rays
    at 64x48 in 32x16 screen tiles, and a shadow-like ray set with bounded
    t_max and dead rays."""
    scene = jscenes.icosphere_scene(3)
    arrays, tree = scene.bake_bvh(block_size=64)
    cam = scene.camera.yaw(0.2).to_arrays()
    perm, _, _ = jcull.tiled_ray_order(W, H, 32, RT // 32)
    d_rows = jraygen.ray_rows_flat(cam, W, H, jnp.asarray(perm))
    rays = np.asarray(jbsr.pack_rays_rows(jnp.asarray(cam.pos), d_rows))
    rng = np.random.default_rng(11)
    r = rays.shape[1]
    shadow = rays.copy()
    shadow[0:3] = np.asarray(scene.light_pos[0], np.float32)[:, None]
    shadow[6] = rng.uniform(2.0, 9.0, r).astype(np.float32)
    live = rng.uniform(size=r) < 0.7
    live[:RT] = False                       # one all-dead tile
    return dict(cam=cam, perm=perm, rays=rays, shadow=shadow, live=live,
                lo=tree.block_lo, hi=tree.block_hi, nb=tree.num_blocks)


def test_ray_rows_flat_matches(setup):
    want = np.asarray(jraygen.ray_rows_flat(setup["cam"], W, H,
                                            jnp.asarray(setup["perm"])))
    got = traygen.ray_rows_flat(tcam(setup["cam"]), W, H,
                                torch.from_numpy(setup["perm"].astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    flat = traygen.ray_directions_flat(
        tcam(setup["cam"]), W, H, torch.arange(W * H + 5))
    want_flat = np.asarray(jraygen.ray_directions_flat(
        setup["cam"], W, H, jnp.arange(W * H + 5)))
    np.testing.assert_allclose(flat.numpy(), want_flat, rtol=1e-6, atol=1e-7)


def test_tiled_ray_order_matches():
    for args in ((64, 48, 32, 16), (50, 37, 32, 16), (640, 480, 16, 16)):
        for g, w in zip(tcull.tiled_ray_order(*args),
                        jcull.tiled_ray_order(*args)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("variant", ["primary", "live", "live_tmax"])
def test_tile_intervals_packed_matches(setup, variant):
    rays = setup["rays"] if variant == "primary" else setup["shadow"]
    live = None if variant == "primary" else setup["live"]
    use_tmax = variant == "live_tmax"
    want = jcull.tile_intervals_packed(
        jnp.asarray(rays), RT, live=None if live is None else jnp.asarray(live),
        use_tmax=use_tmax)
    got = tcull.tile_intervals_packed(
        to_t(rays), RT, live=None if live is None else to_t(live),
        use_tmax=use_tmax)
    for f in tcull.TileIntervals._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


CASES = [  # (groups, ray set)
    ((16,), "rays"), ((2,), "rays"), ((2, 2), "rays"),
    ((2,), "shadow"), ((2, 2), "shadow"),
]


def both_masks(setup, groups, which):
    live = None if which == "rays" else setup["live"]
    use_tmax = which == "shadow"
    ti = jcull.tile_intervals_packed(
        jnp.asarray(setup[which]), RT,
        live=None if live is None else jnp.asarray(live), use_tmax=use_tmax)
    want = jcull.multilevel_mask(ti, jnp.asarray(setup["lo"]),
                                 jnp.asarray(setup["hi"]), groups)
    got = tcull.multilevel_mask(tti(ti), to_t(setup["lo"]), to_t(setup["hi"]),
                                groups)
    return ti, want, got


@pytest.mark.parametrize("groups,which", CASES)
def test_multilevel_mask_matches(setup, groups, which):
    _, (wm, we, wc), (gm, ge, gc) = both_masks(setup, groups, which)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))
    assert gc.dtype == torch.int32 and int(gc) == int(wc) > 0
    assert_entry_close(ge.numpy()[np.asarray(wm)], np.asarray(we)[np.asarray(wm)])


def size_pads(ti, mask, entry, count, lo, hi, groups, margin=1.0):
    """The renderer's sizing walk on the JAX side: one bucket per level."""
    pads = [jbsr.bucket_w_pad(int(count), margin)]
    for _ in groups:
        _, c = jcull.multilevel_worklist(ti, mask, entry, count, lo, hi,
                                         groups, tuple(pads))
        pads.append(jbsr.bucket_w_pad(int(c[-1]), margin))
    return tuple(pads)


@pytest.mark.parametrize("groups,which", CASES)
def test_multilevel_worklist_matches(setup, groups, which):
    ti, (wm, we, wc), (gm, ge, gc) = both_masks(setup, groups, which)
    lo, hi = jnp.asarray(setup["lo"]), jnp.asarray(setup["hi"])
    pads = size_pads(ti, wm, we, wc, lo, hi, groups)
    want, wcounts = jcull.multilevel_worklist(ti, wm, we, wc, lo, hi, groups,
                                              pads)
    got, gcounts = tcull.multilevel_worklist(tti(ti), gm, ge, gc,
                                             to_t(setup["lo"]),
                                             to_t(setup["hi"]), groups, pads)
    assert [int(c) for c in gcounts] == [int(c) for c in wcounts]
    assert_worklist_equal(got, want)
    # Sizing mode (a pad missing): only the next level's count.
    none, short = tcull.multilevel_worklist(tti(ti), gm, ge, gc,
                                            to_t(setup["lo"]),
                                            to_t(setup["hi"]), groups,
                                            pads[:1])
    assert none is None and int(short[0]) == int(wcounts[0])


def test_overflowed_buckets_match(setup):
    """Buckets smaller than the counts (a frozen bucket that overflowed):
    the work lists are truncated exactly as JAX truncates them, and the
    reported counts are still the true ones."""
    groups = (2,)
    ti, (wm, we, wc), (gm, ge, gc) = both_masks(setup, groups, "rays")
    pads = (max(1, int(wc) // 2), 8)
    want, wcounts = jcull.multilevel_worklist(
        ti, wm, we, wc, jnp.asarray(setup["lo"]), jnp.asarray(setup["hi"]),
        groups, pads)
    got, gcounts = tcull.multilevel_worklist(
        tti(ti), gm, ge, gc, to_t(setup["lo"]), to_t(setup["hi"]), groups,
        pads)
    assert int(gcounts[0]) > pads[1]
    assert [int(c) for c in gcounts] == [int(c) for c in wcounts]
    assert_worklist_equal(got, want)


def test_inverted_padding_boxes_never_pass():
    """The slab quotient math alone PASSES (+inf, -inf) inverted boxes, so
    the masks must reject them explicitly (tests/test_bvh.py's case)."""
    inf = float("inf")
    ti = tcull.TileIntervals(
        o_lo=torch.zeros((2, 3)), o_hi=torch.zeros((2, 3)),
        d_lo=torch.full((2, 3), -1.0), d_hi=torch.ones((2, 3)),
        t_hi=torch.full((2,), inf))
    blo = torch.tensor([[-1.0, -1, -1], [inf] * 3])
    bhi = torch.tensor([[1.0, 1, 1], [-inf] * 3])
    mask, _ = tcull.block_mask_with_entry(ti, blo, bhi)
    assert bool(mask[0, 0]) and not bool(mask[:, 1].any())
    want, _ = jcull.block_mask_with_entry(jti(ti), jnp.asarray(blo.numpy()),
                                          jnp.asarray(bhi.numpy()))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want))


def test_phantom_members_stay_in_range():
    """nb not a multiple of the group: the last superblock's phantom members
    never reach the work list, and every block id stays < nb."""
    rng = np.random.default_rng(7)
    nb, group = 9, 4
    blo = rng.uniform(-5, 4, (nb, 3)).astype(np.float32)
    bhi = blo + rng.uniform(0.5, 2, (nb, 3)).astype(np.float32)
    ti = jcull.TileIntervals(
        o_lo=jnp.full((3, 3), -10.0), o_hi=jnp.full((3, 3), -10.0),
        d_lo=jnp.full((3, 3), 0.1), d_hi=jnp.ones((3, 3)),
        t_hi=jnp.full((3,), jnp.inf))
    wm, we, wc = jcull.multilevel_mask(ti, jnp.asarray(blo), jnp.asarray(bhi),
                                       (group,))
    want, _ = jcull.multilevel_worklist(ti, wm, we, wc, jnp.asarray(blo),
                                        jnp.asarray(bhi), (group,), (16, 64))
    gm, ge, gc = tcull.multilevel_mask(tti(ti), to_t(blo), to_t(bhi), (group,))
    got, _ = tcull.multilevel_worklist(tti(ti), gm, ge, gc, to_t(blo),
                                       to_t(bhi), (group,), (16, 64))
    assert int(got.block_ids.max()) < nb and int(got.count) > 0
    assert_worklist_equal(got, want)


@pytest.mark.parametrize("case", ["mask", "entry", "empty", "tiny_pad"])
def test_compact_worklist_matches(case):
    rng = np.random.default_rng(3)
    mask = rng.uniform(size=(5, 7)) < 0.4
    entry = rng.uniform(0, 9, (5, 7)).astype(np.float32)
    entry[0, 0] = np.inf
    if case == "empty":
        mask[:] = False
    w_pad = 4 if case == "tiny_pad" else 64
    e = None if case == "mask" else entry
    want = jcull.compact_worklist(jnp.asarray(mask), w_pad,
                                  entry=None if e is None else jnp.asarray(e))
    got = tcull.compact_worklist(to_t(mask), w_pad,
                                 entry=None if e is None else to_t(e))
    assert_worklist_equal(got, want)
    nt = mask.shape[0]
    np.testing.assert_array_equal(tcull.visited_tiles(got, nt).numpy(),
                                  np.asarray(jcull.visited_tiles(want, nt)))

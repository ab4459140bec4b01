"""Stage B2 of the culled frame (ops/shade_prep.py, csrc/shade_prep.cu).

Without a card: the culled renderer's B2 takes the plain version on the
CPU and counts it; the kernel's outputs are allocated in the plain
version's shapes and strides, q_rev behind an (8, L, C) storage whose
all-lights reshape is a view; the one shadow cull over all lights' hulls
equals the cull per light; the kernel's name falls in the profile's glue.

On the card (`cuda` marker): the kernel against the plain version on the
same CUDA tensors, every output bit for bit (NaN and inf patterns
included), and whole frames (render_fast, render_bounced with its per-ray
viewer, render_dynamic, balanced bands with dead slots) bit for bit
against the same renderers with the plain version swapped in.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu_torch.ops import cull, raygen, shade_prep
from distributed_raytracer_tpu_torch.ops.frozen_graph import tile_bucket
from distributed_raytracer_tpu_torch.ops.intersect import Hits
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.utils import profiling, scenes, tracing
from rtbench import devtrace

W, H = 64, 48


def b2_inputs(r, camera):
    """(scene arrays, rays, hits, viewer, hit tiles) of one primary frame
    at stage B2, sized by the sync render's host syncs."""
    sc = r.dev_scene
    cam = raygen.camera_arrays(camera, r.device)
    rays, ti, m, e, c1 = r._stage_a(sc, cam)
    pads, _ = r._size_pads(sc, ti, m, e, c1)
    hits, hcount, _ = r._stage_b1(sc, pads, rays, ti, m, e, c1)
    return sc, rays, hits, cam.pos, int(hcount)


def bounce_inputs(r, camera):
    """The same at bounce 1: reflection rays, each with its own viewer
    (the primary hit point)."""
    sc, rays, hits, view, hcount = b2_inputs(r, camera)
    sh = r._stage_b2(sc, tile_bucket(hcount, r.n_tiles), rays, hits, view,
                     keep_rays=True)
    rays1, ti, m, e, c1, excl, view1, _ = r._bounce(
        sc, sh, hits, rays.new_ones((3, r.n_pad)))
    pads, _ = r._size_pads(sc, ti, m, e, c1)
    hits1, hcount1, _ = r._nearest(sc, pads, sc.tris_packed, rays1, excl,
                                   ti, m, e, c1)
    return sc, rays1, hits1, view1, int(hcount1)


def bits(x):
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def leaves(x, name="out"):
    """(name, tensor or None) of every field of nested NamedTuples."""
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        for f in x._fields:
            yield from leaves(getattr(x, f), f"{name}.{f}")
    else:
        yield name, x


# -- without a card ------------------------------------------------------


def synthetic(n_lights: int, per_ray_view: bool, rt: int = 128,
              n_tiles: int = 6, ht_pad: int = 4, n_tris: int = 40):
    """prep_tiles' inputs from numpy draws: a tile with no hit, tiles past
    the hit count."""
    g = np.random.default_rng(n_lights * 2 + per_ray_view)
    r = n_tiles * rt
    f32 = lambda *s: torch.from_numpy(g.standard_normal(s).astype(np.float32))
    valid = torch.from_numpy(g.random(r) < 0.7)
    valid[rt:2 * rt] = False
    hits = Hits(t=f32(r).abs(),
                tri=torch.from_numpy(g.integers(0, n_tris, r).astype(
                    np.int32)),
                valid=valid)
    hit_tile = valid.reshape(n_tiles, rt).any(dim=1)
    tidx = torch.argsort((~hit_tile).to(torch.uint8), stable=True)[:ht_pad]
    arrays = SimpleNamespace(light_pos=f32(n_lights, 3) * 5,
                             light_col=f32(n_lights, 3).abs())
    view = f32(3, r) if per_ray_view else f32(3)
    return (f32(8, r), hits, tidx, torch.tensor(ht_pad - 1, dtype=torch.int32),
            arrays, f32(32, n_tris), view)


@pytest.mark.parametrize("n_lights", [0, 1, 3])
@pytest.mark.parametrize("per_ray_view", [False, True])
@pytest.mark.parametrize("keep_rays", [False, True])
def test_kernel_outputs_take_the_plain_versions_shapes_and_strides(
        n_lights, per_ray_view, keep_rays):
    rt = 128
    args = synthetic(n_lights, per_ray_view, rt)
    want = shade_prep.prep_tiles_ref(*args, rt=rt, keep_rays=keep_rays)
    # On the CPU the wrapper is the plain version.
    same = shade_prep.prep_tiles(*args, rt=rt, keep_rays=keep_rays)
    got = shade_prep._outputs(n_lights, args[2].shape[0], rt, args[-1],
                              keep_rays, "cpu")
    for (name, g), (_, w), (_, s) in zip(leaves(got), leaves(want),
                                         leaves(same)):
        if w is None:
            assert g is None and s is None and not keep_rays, name
            continue
        assert (g.shape, g.stride(), g.dtype) == (w.shape, w.stride(),
                                                  w.dtype), name
        assert torch.equal(bits(s), bits(w)), name
    c = args[2].shape[0] * rt
    for prep in (got.prep, want.prep):
        assert prep.q_rev.shape == (n_lights, 8, c)
        flat = prep.q_rev.permute(1, 0, 2).reshape(8, n_lights * c)
        assert flat.data_ptr() == prep.q_rev.data_ptr()
        assert flat._base is not None            # a view, not a copy
        assert torch.equal(
            bits(flat.reshape(8, n_lights, c).permute(1, 0, 2)),
            bits(prep.q_rev))
    if per_ray_view:
        assert got.view_h.shape == (3, c)
    else:
        assert got.view_h is args[-1] and want.view_h is args[-1]


@pytest.fixture(scope="module")
def cpu_renderer():
    scene = scenes.icosphere_scene(1)
    return scene, CulledRenderer(scene, W, H, ray_tile=128, device="cpu")


def test_stage_b2_on_the_cpu_takes_the_plain_path_and_counts_it(
        cpu_renderer, monkeypatch):
    plain = []
    ref = shade_prep.prep_tiles_ref
    monkeypatch.setattr(shade_prep, "prep_tiles_ref",
                        lambda *a, **k: plain.append(1) or ref(*a, **k))
    scene, r = cpu_renderer
    before = dict(tracing.COUNTS)
    r.render(scene.camera)
    assert plain == [1]
    assert tracing.COUNTS == before          # no kernel launched


def test_one_shadow_cull_over_all_lights_equals_one_per_light(cpu_renderer):
    scene, r = cpu_renderer
    sc, rays, hits, view, hcount = b2_inputs(r, scene.camera)
    ht_pad = tile_bucket(hcount, r.n_tiles)
    sh = r._stage_b2(sc, ht_pad, rays, hits, view)
    n_lights = sh.live_l.shape[0]
    assert n_lights == 3 and sh.smasks.shape[:2] == (n_lights, ht_pad)
    total = 0
    for li in range(n_lights):
        rows = slice(li * ht_pad, (li + 1) * ht_pad)
        ti = cull.TileIntervals(*(f[rows] for f in sh.sti))
        want = cull.tile_intervals_packed(sh.prep.q_rev[li], r.rt,
                                          live=sh.live_l[li], use_tmax=True)
        for got_f, want_f in zip(ti, want):
            assert torch.equal(bits(got_f), bits(want_f))
        m, e, c = cull.multilevel_mask(ti, sc.block_lo, sc.block_hi,
                                       r.groups)
        assert torch.equal(sh.smasks[li], m)
        assert torch.equal(bits(sh.sentries[li]), bits(e))
        total += int(c)
    assert int(sh.sc1) == total > 0


def test_a_scene_without_lights_keeps_the_plain_early_return(monkeypatch):
    scene = scenes.icosphere_scene(1, n_lights=0)
    r = CulledRenderer(scene, W, H, ray_tile=128, device="cpu")
    sc, rays, hits, view, hcount = b2_inputs(r, scene.camera)
    plain = []
    ref = shade_prep.prep_tiles_ref
    monkeypatch.setattr(shade_prep, "prep_tiles_ref",
                        lambda *a, **k: plain.append(1) or ref(*a, **k))
    before = tracing.COUNTS["shade_prep"]
    sh = r._stage_b2(sc, tile_bucket(hcount, r.n_tiles), rays, hits, view)
    assert plain == [1] and tracing.COUNTS["shade_prep"] == before
    assert sh.smasks.shape[0] == 0 and sh.sti.o_lo.shape == (0, 3)
    assert int(sh.sc1) == 0
    img = r.render(scene.camera).numpy()
    assert img.shape == (H, W, 3) and (img.sum(-1) > 0).any()


@pytest.mark.parametrize("rt", shade_prep.RAY_TILES)
def test_the_kernel_counts_as_glue_in_a_profile(rt):
    name = (f"void (anonymous namespace)::{shade_prep.KERNEL}<{rt}>("
            "(anonymous namespace)::PrepArgs)")
    assert devtrace.kernel_class(name) == "other"
    assert profiling.kernel_class(name) == "other"


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available)")
    return torch.device("cuda")


def assert_bit_equal(got, want):
    for (name, g), (_, w) in zip(leaves(got), leaves(want), strict=True):
        if w is None:
            assert g is None, name
            continue
        assert (g.shape, g.dtype) == (w.shape, w.dtype), name
        diff = bits(g) != bits(w)
        assert not bool(diff.any()), (f"{name}: {int(diff.sum())} of "
                                      f"{diff.numel()} differ")


def case_scene(case: str):
    if case == "one light":
        return scenes.icosphere_scene(3, n_lights=1)
    if case == "no lights":
        return scenes.icosphere_scene(1, n_lights=0)
    if case == "per-ray viewer":
        return scenes.instanced_grid(scenes.icosphere_scene(2), 2)
    scene = scenes.icosphere_scene(3)
    if case == "dark light":      # light 1 can colour nothing: every tile
        scene.light_col[1] = 0.0  # of it is dead
    return scene


@pytest.mark.cuda
@pytest.mark.parametrize("case, rt", [
    ("padded tiles", 256), ("every tile", 512), ("one light", 128),
    ("dark light", 1024), ("per-ray viewer", 256), ("live slots", 512),
    ("no lights", 128)])
def test_kernel_is_bit_equal_to_the_plain_version(cuda, monkeypatch, case,
                                                  rt):
    scene = case_scene(case)
    r = CulledRenderer(scene, 320, 240, ray_tile=rt, device=cuda)
    if case == "live slots":
        g = np.random.default_rng(7)
        r.set_rays(r._perm.clone(), torch.from_numpy(
            g.random(r.n_pad) < 0.8).to(cuda))
    camera = scene.camera.move(0.4, leftward=True).yaw(0.1)
    inputs = (bounce_inputs if case == "per-ray viewer" else b2_inputs)(
        r, camera)
    sc, rays, hits, view, hcount = inputs
    ht_pad = r.n_tiles if case == "every tile" else tile_bucket(
        hcount, r.n_tiles)
    if case == "padded tiles":
        assert hcount < ht_pad < r.n_tiles
    launches = tracing.COUNTS["shade_prep"]
    got = r._stage_b2(sc, ht_pad, rays, hits, view, keep_rays=True)
    assert tracing.COUNTS["shade_prep"] == launches + 1
    monkeypatch.setattr(shade_prep, "prep_tiles", shade_prep.prep_tiles_ref)
    want = r._stage_b2(sc, ht_pad, rays, hits, view, keep_rays=True)
    torch.cuda.synchronize()
    assert_bit_equal(got, want)
    if case == "no lights":
        assert got.sti.o_lo.shape == (0, 3) and got.smasks.shape[0] == 0
        return
    live = want.live_l.reshape(want.live_l.shape[0], ht_pad, rt).any(dim=2)
    if case == "dark light":
        assert not bool(live[1].any())
        assert bool(torch.isinf(got.sti.o_lo[ht_pad:2 * ht_pad]).all())
    assert bool(live[0, :hcount].any()) and not bool(live[:, hcount:].any())
    if case == "per-ray viewer":
        assert got.view_h.shape == (3, ht_pad * rt)


def frames(cuda, kind: str):
    """One kind of frame, rendered on fresh renderers and buffers."""
    from distributed_raytracer_tpu_torch.ops.render_dynamic import (
        DynamicCulledRenderer)
    from distributed_raytracer_tpu_torch.parallel.mesh import make_mesh
    from distributed_raytracer_tpu_torch.parallel.render_sharded_bvh import (
        make_sharded_culled_renderer)
    from distributed_raytracer_tpu_torch.runtime import animation

    scene = scenes.instanced_grid(scenes.icosphere_scene(2), 2)
    # A tenth of a revolution about the grid's centre: the spheres stay in
    # view.
    poses = animation.orbit_camera_path(
        scene.camera, 3, radius=float(np.linalg.norm(scene.camera.pos)),
        revolutions=0.1)
    if kind == "render_fast":
        r = CulledRenderer(scene, 320, 240, device=cuda)
        r.freeze(poses[0])
        return [r.render_fast(c, verify=True) for c in poses]
    if kind == "render_bounced":
        r = CulledRenderer(scene, 320, 240, device=cuda)
        render = r.freeze_bounced(poses[0], 2)
        return ([r.render_bounced(poses[1], 2)]
                + [render(c, verify=True) for c in poses])
    if kind == "render_dynamic":
        r = DynamicCulledRenderer(scene, 320, 240, device=cuda)
        diffs = animation.orbit_object_diffs(scene, 3)
        return [r.render_dynamic(c, d, verify=True)
                for c, d in zip(poses, diffs)]
    render = make_sharded_culled_renderer(scene, 320, 240,
                                          mesh=make_mesh(2, "cuda"),
                                          balance=True)
    return [render(c, verify=True) for c in poses]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["render_fast", "render_bounced",
                                  "render_dynamic", "balanced bands"])
def test_frames_are_bit_equal_to_the_plain_version(cuda, monkeypatch, kind):
    fused = tracing.COUNTS["shade_prep"]
    got = frames(cuda, kind)
    assert tracing.COUNTS["shade_prep"] > fused
    with monkeypatch.context() as m:
        m.setattr(shade_prep, "prep_tiles", shade_prep.prep_tiles_ref)
        want = frames(cuda, kind)
    torch.cuda.synchronize()
    for k, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(bits(g), bits(w)), f"{kind} frame {k}"
        assert bool((w.sum(-1) > 0).any()), f"{kind} frame {k} is black"

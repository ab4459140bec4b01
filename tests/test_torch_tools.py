"""The port's tools on the CPU: tools/bake_cache.py (a round trip, and a
bundle the JAX package's tool wrote), tools/config_ab.py's per-variant
function and stage split, and tools/xprof.py on a hand-built trace.

A JAX bundle loads with equal arrays, and the port's renderer draws the
frame the JAX renderer (Pallas kernels in interpret mode) draws from it,
to atol 2e-5 (the repository's bound for identical arrays).
"""

import json

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.ops.render_bvh import CulledRenderer as JaxRenderer
from distributed_raytracer_tpu.utils import scenes as jscenes
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.runtime import animation
from distributed_raytracer_tpu_torch.tools import bake_cache, config_ab, xprof
from distributed_raytracer_tpu_torch.utils import scenes
from tests.test_torch_profiling import hand_trace
from tools import bake_cache as jbake_cache


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("DRT_SCENE_CACHE", str(tmp_path))
    monkeypatch.setattr(jbake_cache, "CACHE_DIR", str(tmp_path))
    return tmp_path


def assert_bundles_equal(got, want):
    (ga, gt, gc), (wa, wt, wc) = got, want
    assert ga._fields == wa._fields
    for f in wa._fields:
        g, w = getattr(ga, f), np.asarray(getattr(wa, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert np.array_equal(gt.block_lo, wt.block_lo)
    assert np.array_equal(gt.block_hi, wt.block_hi)
    assert int(gt.block_size) == int(wt.block_size)
    for f in ("pos", "forward", "left", "up"):
        assert np.array_equal(getattr(gc, f), getattr(wc, f)), f
    assert float(gc.fov) == float(wc.fov)


def test_bake_cache_round_trip(cache, capsys):
    assert bake_cache.load_icosphere(2, build_if_missing=False) is None
    built = bake_cache.load_icosphere(2)
    out = capsys.readouterr().out
    assert "synthesis" in out and "bake" in out and "write" in out
    assert (cache / f"icosphere2_bs128_v{bake_cache.VERSION}.npz").exists()
    assert_bundles_equal(bake_cache.load_icosphere(2, False), built)
    scene = scenes.icosphere_scene(2)
    assert_bundles_equal(built, (*scene.bake_bvh(block_size=128),
                                 scene.camera))
    assert capsys.readouterr().out == ""     # loaded, not built again


def test_jax_bundle_loads_and_renders(cache):
    jscene = jscenes.icosphere_scene(2)
    arrays, tree = jscene.bake_bvh(block_size=128)
    jbake_cache.save_bundle("ico2", arrays, tree, jscene.camera)
    got = bake_cache.load_bundle("ico2")
    assert_bundles_equal(got, (arrays, tree, jscene.camera))
    jr = JaxRenderer(None, 64, 48, interpret=True, prebaked=(arrays, tree))
    want = np.asarray(jr.render(jscene.camera.to_arrays()))
    tr = CulledRenderer(None, 64, 48, prebaked=got[:2], device="cpu")
    img = tr.render(got[2]).numpy()
    np.testing.assert_allclose(img, want, atol=2e-5, rtol=0)
    assert (img.sum(-1) > 0).mean() > 0.05
    # And the other way: the port's bundle in the JAX tool.
    bake_cache.save_bundle("ico2p", *got)
    assert_bundles_equal(jbake_cache.load_bundle("ico2p"), got)


def small_config(name: str) -> config_ab.Config:
    scene = scenes.icosphere_scene(2)
    poses = animation.orbit_camera_path(scene.camera, 3, radius=3.0,
                                        revolutions=0.02)
    return config_ab.Config(name, scene, None, scene.camera, 72, 40, poses,
                            2, scene.num_tris)


@pytest.mark.parametrize("variant", ["base", "rt256sq", "rt128"])
def test_config_ab_variant_counts_its_pairs(variant):
    """The pairs are the timed frames' mean scheduled cells (each pose's
    exact sync-render counts) times rt x tb."""
    cfg = small_config("1")
    res = config_ab.run_variant(cfg, variant, device="cpu")
    r, nl = res["renderer"], res["levels"]
    assert nl == r.n_levels and len(res["timed"]) == cfg.frames
    cells = []
    for cam in res["timed"]:
        r.render(cam)
        cells.append(r._last_counts[nl - 1] + r._last_counts[-1])
    assert res["pairs"] == pytest.approx(
        sum(cells) / len(cells) * res["rt"] * res["tb"], rel=1e-12)
    assert res["pairs"] > 0 and len(set(cells)) > 1
    kw = config_ab.VARIANTS[variant]
    assert r.rt == kw.get("ray_tile", 512)
    assert r.tile_w == kw.get("tile_w", 32)
    assert res["ms"] > 0 and res["batched_ms"] > 0
    line = res["line"]
    assert line.startswith(f"config1 {variant}: frame ")
    for part in ("pairs", "Gpairs/s", "SOL", "exit=", "levels=", "setup",
                 f"{cfg.tris} triangles", "batched", "upload"):
        assert part in line, part


def test_config_ab_breakdown_and_fixed_blocks():
    cfg = small_config("5")
    res = config_ab.run_variant(cfg, "base", device="cpu")
    assert "batched_ms" not in res
    split = config_ab.breakdown(res["renderer"], cfg.camera, reps=1)
    assert list(split) == ["A raygen + top mask",
                           "primary sizing (host syncs)", "B1 work list + K1",
                           "B2 compaction + prep + shadow masks",
                           "shadow sizing (host syncs)",
                           "C shadow work list + K2 + shade"]
    assert all(ms > 0 for ms in split.values())
    r = res["renderer"]
    prebaked = config_ab.Config("5", None, (r.arrays_host, r.tree),
                                cfg.camera, 64, 48, cfg.poses, 1, cfg.tris)
    with pytest.raises(ValueError, match="fixes its blocks"):
        config_ab.run_variant(prebaked, "bs64", device="cpu")
    assert set(config_ab.CONFIG5_VARIANTS) <= set(config_ab.VARIANTS)


def test_xprof_prints_the_anatomy(tmp_path, capsys):
    path = tmp_path / "run" / "1.pt.trace.json"
    path.parent.mkdir()
    path.write_text(json.dumps({"traceEvents": hand_trace()}))
    assert xprof.main([str(tmp_path), "2", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == f"trace: {path}"
    assert lines[1] == ("== device: 0.145 ms/frame (kernels 0.120, copies "
                        "0.025) of a 0.500 ms/frame window; busy 0.2400; 1.5 "
                        "kernels and 2.0 host launch calls per frame")
    assert lines[3:5] == [
        "     0.0500 ms x    1  [K1] void nearest_chunk_kernel<4, true>(Args)",
        "     0.0500 ms x    1  [K2] void any_chunk_kernel<4, true>(Args)"]
    assert lines[5] == "== idle gaps of the card, longest first"
    assert lines[6] == ("     0.3500 ms at +0.650 ms under cuda_runtime "
                        "cudaStreamSynchronize")
    assert len(lines) == 6 + 4

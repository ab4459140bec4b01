"""The PyTorch port's command line and runtime helpers.

`python -m distributed_raytracer_tpu_torch` renders the tetra scene on the
CPU and must write the frames the port's own render() (render_bounced()
with --bounces, render_dynamic() with --animate-objects, render_frame()
with --mode sequential, the sharded renderer with --mode sharded, the
one-rank culled frames with --mode sharded-bvh, --mode halo and --mode
ring) gives; --serve in each of those modes serves the loop until a client
sends Esc; --multihost, which is not ported yet, exits non-zero with a
message that names it. The runtime helpers copied from the JAX package (FPS statistics, PNG encoding, the orbit
path) must give identical results.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.runtime import animation as janimation
from distributed_raytracer_tpu.runtime import framebuffer as jframebuffer
from distributed_raytracer_tpu.runtime import stats as jstats
from distributed_raytracer_tpu_torch import run
from distributed_raytracer_tpu_torch.models.scene import load_scene
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.runtime import animation, framebuffer
from distributed_raytracer_tpu_torch.runtime import stats
from tests.conftest import make_tetra_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    make_tetra_obj(str(d / "tetra.obj"))
    p = d / "scene.json"
    p.write_text(
        '{"objs": [{"model": "tetra.obj", "pos": {"x": 0, "y": 0, "z": 0}}],'
        '"lights": [{"pos": {"x": 3, "y": 4, "z": 5},'
        '"col": {"r": 255, "g": 255, "b": 255}}],'
        '"cam": {"pos": {"x": 1.5, "y": 1.2, "z": 3.0},'
        '"dir": {"x": -0.35, "y": -0.3, "z": -1.0}, "fov": 1.0472}}')
    return str(p)


def run_module(args):
    return subprocess.run(
        [sys.executable, "-m", "distributed_raytracer_tpu_torch", *args],
        capture_output=True, text=True, timeout=300, cwd=REPO)


def test_cli_writes_the_frames_render_gives(scene_path, tmp_path):
    out = str(tmp_path / "frames")
    res = run_module([scene_path, "64", "48", "--frames", "2",
                      "--fps-target", "0", "--device", "cpu", "--out", out,
                      "--radius", "3"])
    assert res.returncode == 0, res.stderr[-2000:]
    assert "Mean FPS" in res.stdout and "Throughput" in res.stdout
    files = sorted(os.listdir(out))
    assert files == ["frame_00000.png", "frame_00001.png"]
    scene = load_scene(scene_path)
    r = CulledRenderer(scene, 64, 48, block_size="auto", device="cpu")
    poses = animation.orbit_camera_path(scene.camera, 2, radius=3.0)
    for k, cam in enumerate(poses):
        want = framebuffer.to_u8(r.render(cam).numpy())
        got = jframebuffer.read_png(os.path.join(out, files[k]))
        np.testing.assert_array_equal(got, want)
        assert want.max() > (50 if k == 0 else 0)   # lit front, ambient back


@pytest.mark.parametrize("flags,name", [
    (["--mode", "halo", "--multihost"], "--multihost"),
    (["--mode", "halo", "--bounces", "1", "--multihost"], "--multihost"),
    (["--mode", "halo", "--devices", "2", "--multihost"], "--multihost"),
    (["--mode", "halo", "--serve", "127.0.0.1:0", "--multihost"],
     "--multihost"),
    (["--multihost"], "--multihost"),
])
def test_unported_options_exit_with_their_name(scene_path, flags, name):
    with pytest.raises(SystemExit) as exc:
        run.main([scene_path, "64", "48", "--device", "cpu", *flags])
    assert isinstance(exc.value.code, str)     # exit status 1
    assert name in exc.value.code and "not yet ported" in exc.value.code


@pytest.mark.parametrize("flags", [
    [], ["--bounces", "1"], ["--animate-objects"], ["--mode", "sequential"],
    ["--mode", "sharded", "--devices", "2"],
    ["--mode", "sharded-bvh", "--devices", "2"],
    ["--mode", "halo", "--devices", "2"],
    ["--mode", "ring", "--devices", "2"]])
def test_cli_serve_ends_on_esc(scene_path, flags, monkeypatch, capsys):
    """--serve runs the interactive loop behind the browser viewer: a
    client holds "w" until a frame is shown, fetches it and the stats,
    then sends Esc, and run.main returns 0."""
    import json
    import threading
    import time
    import urllib.request

    from distributed_raytracer_tpu_torch.runtime import viewer

    seen = {}
    serve = viewer.serve

    def post(v, ev):
        urllib.request.urlopen(urllib.request.Request(
            v.url + "input", method="POST", data=json.dumps(ev).encode()),
            timeout=30).read()

    def client(v):
        post(v, {"kind": "key_down", "key": "w"})
        deadline = time.monotonic() + 120
        while v.stats_dict()["frames"] < 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        with urllib.request.urlopen(v.url + "frame.png", timeout=30) as r:
            seen["png"] = r.read()
        with urllib.request.urlopen(v.url + "stats", timeout=30) as r:
            seen["stats"] = json.loads(r.read())
        post(v, {"kind": "key_down", "key": "esc"})

    def serve_with_client(*args, on_ready=None, **kwargs):
        def ready(v):
            on_ready(v)
            threading.Thread(target=client, args=(v,), daemon=True).start()
        return serve(*args, on_ready=ready, **kwargs)

    monkeypatch.setattr(viewer, "serve", serve_with_client)
    assert run.main([scene_path, "32", "24", "--device", "cpu", "--serve",
                     "127.0.0.1:0", *flags]) == 0
    out = capsys.readouterr().out
    assert "viewer at http://127.0.0.1:" in out
    assert "Frames dropped: 0." in out
    assert seen["png"].startswith(b"\x89PNG") and seen["stats"]["frames"] >= 1


def test_cli_bounces_report_fps(scene_path, tmp_path, capsys):
    out = str(tmp_path / "frames")
    assert run.main([scene_path, "64", "48", "--bounces", "1", "--frames",
                     "2", "--fps-target", "0", "--device", "cpu", "--out",
                     out, "--radius", "3"]) == 0
    report = capsys.readouterr().out
    assert "Mean FPS" in report and "Throughput" in report
    scene = load_scene(scene_path)
    r = CulledRenderer(scene, 64, 48, block_size="auto", device="cpu")
    poses = animation.orbit_camera_path(scene.camera, 2, radius=3.0)
    for k, cam in enumerate(poses):
        want = framebuffer.to_u8(r.render_bounced(cam, 1).numpy())
        got = jframebuffer.read_png(os.path.join(out, f"frame_{k:05d}.png"))
        np.testing.assert_array_equal(got, want)


def test_cli_animate_objects_writes_render_dynamic_frames(scene_path,
                                                         tmp_path, capsys):
    """Object 0 orbits through per-frame SceneDiffs (block size 128 and a
    verify every 8th frame, as in the JAX CLI)."""
    from distributed_raytracer_tpu_torch.ops.render_dynamic import (
        DynamicCulledRenderer)

    out = str(tmp_path / "frames")
    assert run.main([scene_path, "64", "48", "--animate-objects", "--frames",
                     "3", "--object-radius", "0.5", "--fps-target", "0",
                     "--device", "cpu", "--out", out, "--radius", "3"]) == 0
    report = capsys.readouterr().out
    assert "Mean FPS" in report and "Throughput" in report
    scene = load_scene(scene_path)
    r = DynamicCulledRenderer(scene, 64, 48, device="cpu")
    r.render(scene.camera, block=True)
    r.freeze(scene.camera)
    diffs = animation.orbit_object_diffs(scene, 3, radius=0.5)
    poses = animation.orbit_camera_path(scene.camera, 3, radius=3.0)
    frames = set()
    for k, cam in enumerate(poses):
        want = framebuffer.to_u8(r.render_dynamic(cam, diffs[k],
                                                  verify=True).numpy())
        got = jframebuffer.read_png(os.path.join(out, f"frame_{k:05d}.png"))
        np.testing.assert_array_equal(got, want)
        frames.add(got.tobytes())
    assert len(frames) == 3


@pytest.mark.parametrize("flags", [["--bounces", "1"],
                                   ["--mode", "sequential"]])
def test_cli_animate_objects_refuses_bounces(scene_path, flags):
    with pytest.raises(SystemExit) as exc:
        run.main([scene_path, "64", "48", "--animate-objects", *flags,
                  "--device", "cpu"])
    assert exc.value.code == ("--animate-objects supports --mode "
                              "culled/halo/ring (--bounces on halo/ring)")


@pytest.mark.parametrize("flags", [["--mode", "sequential"],
                                   ["--mode", "sharded", "--devices", "4"]])
def test_cli_dense_modes_write_render_frame(scene_path, tmp_path, capsys,
                                            flags):
    """The dense sweep, on one device or row-sharded over 4 CPU ranks,
    writes the frames render_frame gives."""
    from distributed_raytracer_tpu_torch.ops.render import (render_frame,
                                                            scene_on)

    out = str(tmp_path / "frames")
    assert run.main([scene_path, "64", "48", *flags, "--frames", "2",
                     "--fps-target", "0", "--device", "cpu", "--out", out,
                     "--radius", "3"]) == 0
    report = capsys.readouterr().out
    assert "Mean FPS" in report and "Throughput" in report
    scene = load_scene(scene_path)
    arrays = scene_on(scene.bake(), "cpu")
    poses = animation.orbit_camera_path(scene.camera, 2, radius=3.0)
    for k, cam in enumerate(poses):
        want = render_frame(arrays, cam, 64, 48)
        got = jframebuffer.read_png(os.path.join(out, f"frame_{k:05d}.png"))
        # Sharding may round the shading differently by an ulp: a u8
        # channel then differs by at most 1.
        diff = np.abs(got.astype(int) - framebuffer.to_u8(want.numpy()))
        assert diff.max() <= (0 if flags[1] == "sequential" else 1)
        assert got.max() > 0


@pytest.mark.parametrize("flags", [
    ["--mode", "sharded-bvh", "--devices", "2"],
    ["--mode", "sharded-bvh", "--devices", "2", "--balance"],
    ["--mode", "sharded-bvh", "--devices", "2", "--bounces", "1"],
    ["--mode", "ring", "--devices", "2"],
    ["--mode", "ring", "--bounces", "1"],
    ["--mode", "ring", "--devices", "2", "--animate-objects"],
    ["--mode", "halo", "--devices", "2"],
    ["--mode", "halo", "--devices", "2", "--bounces", "1"],
    ["--mode", "halo", "--devices", "2", "--animate-objects"]])
def test_cli_culled_multi_rank_modes_write_the_one_rank_frames(
        scene_path, tmp_path, capsys, flags):
    """Bands (equal, balanced, bounced), the geometry halo and the
    geometry ring over CPU ranks write the frames the one-rank culled renderer gives for the same
    bake (block size 128): render(), render_bounced() with --bounces, and
    with --animate-objects the dynamic renderer's render_dynamic() of the
    same orbit diffs."""
    from distributed_raytracer_tpu_torch.ops.render_dynamic import (
        DynamicCulledRenderer)

    out = str(tmp_path / "frames")
    assert run.main([scene_path, "64", "48", *flags, "--frames", "2",
                     "--fps-target", "0", "--device", "cpu", "--out", out,
                     "--radius", "3", "--object-radius", "0.5"]) == 0
    report = capsys.readouterr().out
    assert "Mean FPS" in report and "Throughput" in report
    scene = load_scene(scene_path)
    poses = animation.orbit_camera_path(scene.camera, 2, radius=3.0)
    if "--animate-objects" in flags:
        r = DynamicCulledRenderer(scene, 64, 48, device="cpu")
        r.freeze(scene.camera)
        diffs = animation.orbit_object_diffs(scene, 2, radius=0.5)
        frame = lambda k, cam: r.render_dynamic(cam, diffs[k], verify=True)
    else:
        r = CulledRenderer(scene, 64, 48, device="cpu")
        bounces = int(flags[flags.index("--bounces") + 1]
                      if "--bounces" in flags else 0)
        frame = lambda k, cam: r.render_bounced(cam, bounces)
    for k, cam in enumerate(poses):
        want = framebuffer.to_u8(frame(k, cam).numpy())
        got = jframebuffer.read_png(os.path.join(out, f"frame_{k:05d}.png"))
        np.testing.assert_array_equal(got, want)
        assert got.max() > 0


def test_unported_mode_exits_nonzero(scene_path):
    res = run_module([scene_path, "64", "48", "--mode", "halo",
                      "--multihost"])
    assert res.returncode == 1
    assert "--multihost is not yet ported" in res.stderr


def test_frame_stats_match():
    ts = [0.0, 0.031, 0.065, 0.0952, 0.13, 0.171]
    want, got = jstats.FrameTimer(), stats.FrameTimer()
    for timer in (want, got):
        for t in ts:
            timer.frame_issued()
            timer.frame_drawn(at=t)
    assert got.stats().report() == want.stats().report()
    assert got.stats().fps_per_frame == want.stats().fps_per_frame


def test_png_and_u8_match():
    rng = np.random.default_rng(4)
    img = rng.uniform(-0.2, 1.2, (7, 9, 3)).astype(np.float32)
    np.testing.assert_array_equal(framebuffer.to_u8(img),
                                  jframebuffer.to_u8(img))
    np.testing.assert_array_equal(
        framebuffer.to_u8_device(torch.from_numpy(img)).numpy(),
        jframebuffer.to_u8(img))
    assert framebuffer.png_bytes(img) == jframebuffer.png_bytes(img)


def test_orbit_camera_path_matches(scene_path):
    from distributed_raytracer_tpu.models.scene import load_scene as jload

    want = janimation.orbit_camera_path(jload(scene_path).camera, 5,
                                        radius=3.0, revolutions=0.5)
    got = animation.orbit_camera_path(load_scene(scene_path).camera, 5,
                                      radius=3.0, revolutions=0.5)
    for g, w in zip(got, want):
        for f in ("pos", "forward", "left", "up"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))

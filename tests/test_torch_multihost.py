"""The port's multi-process runs (parallel/multihost.py, --multihost) on the
CPU: real OS processes over gloo, each with 2 CPU ranks, the torch
counterpart of tests/test_multihost.py.

Each case spawns the processes through
distributed_raytracer_tpu_torch/tools/multihost_worker.py on the tetra
scene of tests/test_multihost.py at 48x36. Process 0's frame must equal the
port's single-process frame over [cpu] * 4 bit for bit (the collectives
only move bytes), and lie within atol 2e-5 of the JAX package's
single-process render_frame (render_frame_bounced at depth 1 for the
bounced bands). Every child runs under a timeout; a case that times out
kills the children and fails with their stderr.
"""

import json
import os
import sys

import numpy as np
import pytest

from distributed_raytracer_tpu_torch.tools.multihost_worker import (free_port,
                                                                   run_all)
from tests.conftest import make_tetra_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 48, 36
TIMEOUT_S = 240


@pytest.fixture(scope="module")
def scene_path(tmp_path_factory):
    d = tmp_path_factory.mktemp("mh_torch")
    make_tetra_obj(str(d / "tetra.obj"))
    p = d / "scene.json"
    p.write_text(
        '{"objs": [{"model": "tetra.obj", "pos": {"x": 0, "y": 0, "z": 0}}],'
        '"lights": [{"pos": {"x": 3, "y": 4, "z": 5},'
        '"col": {"r": 255, "g": 255, "b": 255}}],'
        '"cam": {"pos": {"x": 1.5, "y": 1.2, "z": 3.0},'
        '"dir": {"x": -0.35, "y": -0.3, "z": -1.0}, "fov": 1.0472}}')
    return str(p)


def _spawn(cmds) -> list:
    """Runs the commands as processes at once (multihost_worker.run_all);
    returns their stdouts. A process that fails or outlasts TIMEOUT_S gets
    every process killed and fails the case with each one's stderr."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    try:
        return run_all(cmds, [env] * len(cmds), TIMEOUT_S, cwd=REPO)
    except RuntimeError as e:
        pytest.fail(str(e))


def _run_workers(scene_path, tmp_path, modes: str, nproc: int = 2,
                 extra=()):
    """nproc worker processes of 2 CPU ranks each running `modes`:
    (every process's JSON report, {mode: process 0's frame})."""
    port = free_port()
    out = str(tmp_path / "frame")
    cmd = lambda pid: [sys.executable, "-m",
                       "distributed_raytracer_tpu_torch.tools."
                       "multihost_worker", str(pid), str(nproc), str(port),
                       scene_path, out, modes, "--device", "cpu", *extra]
    stdouts = _spawn([cmd(i) for i in range(nproc)])
    reports = [json.loads(s.strip().splitlines()[-1]) for s in stdouts]
    frames = {m: np.load(f"{out}-{m}.npy") for m in modes.split(",")}
    return reports, frames


def _single_process(scene_path, mode, w=W, h=H, **kw):
    """The port's frame of `mode` over [cpu] * 4 in this process, through
    the worker's own path."""
    from distributed_raytracer_tpu_torch.tools import multihost_worker as mw

    scene = mw.load(scene_path)
    return mw.render_case(mode, scene, w, h, ["cpu"] * 4, **kw)


def _jax_frame(scene_path, bounced: bool) -> np.ndarray:
    import jax

    from distributed_raytracer_tpu.models.scene import load_scene
    from distributed_raytracer_tpu.ops.render import (render_frame,
                                                      render_frame_bounced)

    scene = load_scene(scene_path)
    arrays = jax.device_put(scene.bake())
    if bounced:
        return np.asarray(render_frame_bounced(
            arrays, scene.camera.to_arrays(), W, H, 1))
    return np.asarray(render_frame(arrays, scene.camera.to_arrays(), W, H))


@pytest.mark.parametrize("mode,nproc", [
    ("dense", 2),
    ("sharded-bvh", 2),
    pytest.param("sharded-bvh", 4, marks=pytest.mark.slow),
    ("sharded-bvh-balanced", 2),
    ("sharded-bvh-bounced", 2),
    ("halo", 2),
    pytest.param("halo", 4, marks=pytest.mark.slow),
    ("ring", 2),
    pytest.param("ring", 4, marks=pytest.mark.slow),
])
def test_multi_process_frame_equals_single_process(scene_path, tmp_path,
                                                   mode, nproc):
    """Process 0's frame of every schedule equals the single-process 4-rank
    frame bit for bit and JAX's single-process frame within 2e-5; every
    process froze the same buckets, saw the same counts and baked the same
    arrays, and process 0 alone saved a frame."""
    import torch

    reports, frames = _run_workers(scene_path, tmp_path, mode, nproc)
    got = frames[mode]
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    assert [r["process"] for r in reports] == list(range(nproc))
    assert {r["backend"] for r in reports} == {"gloo"}
    assert [r["ranks"] for r in reports] == [[2 * i, 2 * i + 1]
                                             for i in range(nproc)]
    runs = [r["modes"][mode] for r in reports]
    for key in ("buckets", "counts", "layout", "checksum"):
        assert all(run[key] == runs[0][key] for run in runs), key
    if nproc == 2:
        # The single-process reference over the same four ranks: the same
        # frame, buckets, counts and (balanced) layout, struck on process 0
        # and broadcast.
        torch.set_num_threads(1)
        want = _single_process(scene_path, mode)
        np.testing.assert_array_equal(got, want["frame"])
        for key in ("buckets", "counts", "layout"):
            assert want[key] == runs[0][key], key
        assert want["checksum"].startswith(runs[0]["checksum"])
        if mode == "sharded-bvh-balanced":
            assert want["layout"] is not None
    ref = _jax_frame(scene_path, mode == "sharded-bvh-bounced")
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_refreeze_is_collective(scene_path, tmp_path):
    """Bands sized on a pose that sees nothing, then a frame whose
    geometry lies in the lower half of the frame only: its counts overflow
    the buckets on process 1's bands (2 and 3) and on none of process 0's.
    Both processes refreeze to the same buckets, and the frame equals the
    single-process frame of the same sizing and pose bit for bit."""
    import torch

    size, pitch, away = (256, 192), 0.3, float(np.pi)
    reports, frames = _run_workers(
        scene_path, tmp_path, "sharded-bvh",
        extra=["--size", f"{size[0]}x{size[1]}", "--pitch", str(pitch),
               "--sizing-yaw", str(away)])
    runs = [r["modes"]["sharded-bvh"] for r in reports]
    before, after = runs[0]["buckets"]["before"], runs[0]["buckets"]["after"]
    counts = np.asarray(runs[0]["counts"])
    over = counts > np.asarray(before)[None, :]
    assert not over[:2].any() and over[2:].any(), counts
    assert after != before
    assert all(run["buckets"] == runs[0]["buckets"] for run in runs)
    assert all(run["counts"] == runs[0]["counts"] for run in runs)
    torch.set_num_threads(1)
    from distributed_raytracer_tpu_torch.tools import multihost_worker as mw

    scene = mw.load(scene_path)
    want = _single_process(scene_path, "sharded-bvh", *size,
                           camera=scene.camera.pitch(pitch),
                           sizing_camera=scene.camera.yaw(away))
    assert want["buckets"]["after"] == after
    np.testing.assert_array_equal(frames["sharded-bvh"], want["frame"])


def test_cli_multihost(scene_path, tmp_path):
    """--multihost over 2 processes of the port's CLI, --mode sharded over
    4 CPU ranks: process 0 prints the FPS report and writes both frames;
    process 1 prints no report."""
    port = free_port()
    out = str(tmp_path / "frames")

    def code(pid):
        return ("import sys, torch; torch.set_num_threads(1);"
                "from distributed_raytracer_tpu_torch.run import main;"
                f"sys.exit(main([{scene_path!r}, '40', '30', '--mode', "
                "'sharded', '--frames', '2', '--fps-target', '0', "
                f"'--animation', 'none', '--out', {out!r}, '--multihost', "
                f"'--coordinator', '127.0.0.1:{port}', '--num-processes', "
                f"'2', '--process-id', '{pid}', '--device', 'cpu', "
                "'--devices', '4']))")

    stdouts = _spawn([[sys.executable, "-c", code(i)] for i in range(2)])
    assert "Mean FPS" in stdouts[0]
    assert "Mean FPS" not in stdouts[1]
    assert "transport gloo" in stdouts[1]
    assert sorted(os.listdir(out)) == ["frame_00000.png", "frame_00001.png"]


def test_cli_multihost_refuses_uneven_devices(scene_path):
    """--devices must split evenly over the processes; the CLI says so
    before it joins any job."""
    from distributed_raytracer_tpu_torch.run import main

    with pytest.raises(SystemExit, match="split evenly"):
        main([scene_path, "40", "30", "--mode", "sharded", "--multihost",
              "--coordinator", "127.0.0.1:1", "--num-processes", "2",
              "--process-id", "0", "--device", "cpu", "--devices", "3"])


def test_single_process_multihost_is_the_local_mesh():
    """Without a coordinator, initialize does nothing, the global mesh is
    the local one, and gather_frame hands the frame back as numpy."""
    import torch

    from distributed_raytracer_tpu_torch.parallel import multihost

    assert multihost.initialize() is None
    assert multihost.is_master()
    assert multihost.global_mesh(4, "cpu") == (torch.device("cpu"),) * 4
    frame = torch.arange(6.0).reshape(1, 2, 3)
    np.testing.assert_array_equal(multihost.gather_frame(frame),
                                  frame.numpy())
    assert multihost.gather_frame(None) is None
    multihost.shutdown()


def test_geometry_on_every_rank_crosses_processes(tmp_path):
    """The tetra's 4 triangles fill one block, so on its halo and ring only
    rank 0 holds geometry. Four mirrored spheres (1,280 triangles in 10
    blocks) give every rank a shard: candidates, shadow bits and rotating
    shards then cross the process boundary both ways, and the frames must
    still equal the single-process frames bit for bit."""
    import torch

    modes = "halo,ring"
    reports, frames = _run_workers("grid:2:2", tmp_path, modes,
                                   extra=["--size", "64x48"])
    torch.set_num_threads(1)
    for mode in modes.split(","):
        runs = [r["modes"][mode] for r in reports]
        assert all(run["counts"] == runs[0]["counts"] for run in runs)
        if mode == "halo":
            # Every rank's shard met rays: each culled work against it.
            assert all(c[0] > 0 for c in runs[0]["counts"]), runs[0]
        want = _single_process("grid:2:2", mode, 64, 48)
        np.testing.assert_array_equal(frames[mode], want["frame"])


COLLECTIVES = r"""
import sys
import torch
torch.set_num_threads(1)
from distributed_raytracer_tpu_torch.parallel import mesh, multihost

pid, port = int(sys.argv[1]), sys.argv[2]
multihost.initialize(f"127.0.0.1:{port}", 2, pid, device="cpu")
ranks = mesh.Ranks(multihost.global_mesh(4, "cpu"))
one = mesh.Ranks(["cpu"] * 4)
assert ranks.local == (2 * pid, 2 * pid + 1), ranks.local
make = lambda r, k: (torch.arange(24, dtype=torch.float32).reshape(8, 3)
                     + 100 * r + k)
xs = [make(r, 0) for r in range(4)]
mine = lambda vals: [v if ranks.is_local(r) else None
                     for r, v in enumerate(vals)]


def same(got, want, what):
    for r in ranks.local:
        assert torch.equal(got[r], want[r]), (what, r)
    for r in set(range(4)) - set(ranks.local):
        assert got[r] is None, (what, r)


same(mesh.rotate_right(ranks, mine(xs)), mesh.rotate_right(one, xs),
     "rotate_right")
for dim in (0, 1):
    same(mesh.all_gather(ranks, mine(xs), dim=dim),
         mesh.all_gather(one, xs, dim=dim), f"all_gather {dim}")
bits = [(make(r, 1)[:, 0] % 3 == 0) for r in range(4)]
same(mesh.all_gather(ranks, mine(bits)), mesh.all_gather(one, bits),
     "all_gather bool")
same(mesh.all_to_all(ranks, mine(xs)), mesh.all_to_all(one, xs),
     "all_to_all")
ids = [torch.tensor([0, 5, 9, 14, 31, 2, 17, 40], dtype=torch.int32) + r
       for r in range(4)]
tables = [make(r, 2)[:, :2].repeat(1, 1) for r in range(4)]
same(mesh.fetch_rows(ranks, mine(ids), mine(tables), 8),
     mesh.fetch_rows(one, ids, tables, 8), "fetch_rows")
got = mesh.gather(ranks, mine(xs))
assert (got is None) == (pid != 0)
if pid == 0:
    assert torch.equal(got, mesh.gather(one, xs))
assert torch.equal(mesh.gather(ranks, mine(xs), everywhere=True),
                   mesh.gather(one, xs))
assert ranks.max_over_processes([pid, 5 - pid]).tolist() == [1, 5]
assert ranks.broadcast([pid + 7], 3).tolist() == [8]
multihost.shutdown()
print("ok")
"""


def test_collectives_cross_processes():
    """Every collective of parallel/mesh.py over 2 processes of 2 CPU
    ranks gives each local rank what it gives over one process's 4 ranks,
    and None at the other process's ranks; gather lands on process 0 (or
    everywhere), and the host values agree."""
    port = free_port()
    outs = _spawn([[sys.executable, "-c", COLLECTIVES, str(i), str(port)]
                   for i in range(2)])
    assert [o.strip().splitlines()[-1] for o in outs] == ["ok", "ok"]

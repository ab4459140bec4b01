"""The port's browser viewer (runtime/viewer.py): the JAX package's
tests/test_viewer.py cases (HTTP surface, run_loop driven through the
viewer, serve() ending on Esc) against the port's modules, plus the
viewer driving the port's loop over its CPU renderer."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu_torch.models.scene import from_reference
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.runtime import framebuffer
from distributed_raytracer_tpu_torch.runtime import viewer as viewer_mod
from distributed_raytracer_tpu_torch.runtime.loop import run_loop
from tests.test_torch_render_many import port_camera


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the module runs beside others under xdist."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.status, r.read()


def _post(url, ev):
    req = urllib.request.Request(url + "input", method="POST",
                                 data=json.dumps(ev).encode())
    with urllib.request.urlopen(req, timeout=5) as r:
        return r.status


def test_viewer_http_surface():
    v = viewer_mod.ViewerServer(port=0)
    try:
        status, body = _get(v.url)
        assert status == 200 and b"/stream" in body

        with pytest.raises(urllib.error.HTTPError) as e:   # no frame yet
            _get(v.url + "frame.png")
        assert e.value.code == 404

        img = np.zeros((24, 32, 3), np.float32)
        img[:, :, 0] = 1.0
        v.display(0, img)
        status, body = _get(v.url + "frame.png")
        assert status == 200 and body.startswith(b"\x89PNG")

        assert _post(v.url, {"kind": "key_down", "key": "w"}) == 200
        assert _post(v.url, {"kind": "mouse", "dx": 3, "dy": -2}) == 200
        evs = v.drain_events()
        assert ("key_down", "w") in evs
        assert ("mouse", 3.0, -2.0) in evs

        status, body = _get(v.url + "stats")
        assert status == 200 and json.loads(body)["frames"] == 1

        req = urllib.request.Request(v.url + "input", method="POST",
                                     data=b"{not json")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=5)
        assert e.value.code == 400
    finally:
        v.stop()


def test_viewer_drives_run_loop(tetra_scene):
    """Browser events -> controller -> frames -> viewer, ending on Esc."""
    camera = port_camera(tetra_scene.camera)
    v = viewer_mod.ViewerServer(port=0)
    calls = []

    def render_fn(scene_arrays, cam_arrays):
        calls.append(cam_arrays)
        return np.zeros((12, 16, 3), np.float32)

    v.push_event({"kind": "key_down", "key": "w"})

    def later():
        time.sleep(0.2)
        v.push_event({"kind": "key_up", "key": "w"})
        v.push_event({"kind": "key_down", "key": "esc"})

    t = threading.Thread(target=later)
    t.start()
    try:
        cam, stats, dropped = run_loop(
            None, camera, render_fn, 16, 12,
            events=v.events(), display=v.display, realtime=True)
        t.join()
        assert len(calls) >= 1
        assert v.stats_dict()["frames"] == len(calls)
        assert dropped == 0
        assert not np.allclose(np.asarray(cam.pos), np.asarray(camera.pos))
    finally:
        v.stop()


def test_viewer_serve_until_esc(tetra_scene):
    """The blocking serve() helper ends when a client sends Esc."""
    def render_fn(scene_arrays, cam_arrays):
        return np.zeros((12, 16, 3), np.float32)

    def on_ready(v):
        def quit_later():
            time.sleep(0.2)
            v.push_event({"kind": "key_down", "key": "esc"})

        threading.Thread(target=quit_later, daemon=True).start()

    cam, stats, dropped = viewer_mod.serve(
        None, port_camera(tetra_scene.camera), render_fn, 16, 12, port=0,
        on_ready=on_ready)
    assert dropped == 0


def test_viewer_serves_the_port_renderer(tetra_scene, tmp_path):
    """serve() over the port's frozen renderer on the CPU: a client holds
    "w" over HTTP until a frame is shown, fetches it, releases and sends
    Esc; the camera moved 0.1 per frame, and the last frame shown is the
    renderer's frame of the final camera."""
    w, h = 32, 24
    cam0 = port_camera(tetra_scene.camera)
    r = CulledRenderer(None, w, h, prebaked=from_reference(
        *tetra_scene.bake_bvh(block_size=64)), device="cpu")
    r.render(cam0, block=True)
    r.freeze(cam0)
    got = {}

    def client(v):
        got["viewer"] = v

        def run():
            _post(v.url, {"kind": "key_down", "key": "w"})
            deadline = time.monotonic() + 60
            while v.stats_dict()["frames"] < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            got["png"] = _get(v.url + "frame.png")[1]
            _post(v.url, {"kind": "key_up", "key": "w"})
            _post(v.url, {"kind": "key_down", "key": "esc"})

        threading.Thread(target=run, daemon=True).start()

    cam, stats, dropped = viewer_mod.serve(
        None, cam0, lambda s, c: r.render_fast(c), w, h, port=0,
        on_ready=client)
    assert dropped == 0 and got["png"].startswith(b"\x89PNG")
    n = stats.frames_total
    assert n >= 1 and stats.frames_drawn == n
    np.testing.assert_allclose(cam.pos, cam0.pos + 0.1 * n * cam0.forward,
                               atol=1e-9)
    path = tmp_path / "last.png"
    path.write_bytes(got["viewer"].latest_png())
    want = framebuffer.to_u8(r.render_fast(cam).numpy())
    assert np.array_equal(framebuffer.read_png(str(path)), want)

"""The port's utils/profiling.py against the JAX package's, and its trace
anatomy on a hand-built chrome trace.

FrameWork counts the same scheduled pairs and Gpairs/s as the JAX
package's for the same inputs (more than 2^31 pairs included, and counts
given as 32-bit numpy scalars, which must not wrap); its roofline is the
H100's (21 FP32 operations per pair over 67 TFLOP/s, the tensor-core form
by its larger bound). anatomy() reads a trace whose answers are known by hand:
two overlapping kernels, one more kernel, a copy, idle gaps under known
host events, and launch calls. tools/kernel_ab._profile and
tools/schedule_frames.profile, which parse their traces through anatomy(),
return what their own parsers returned on the same trace.
"""

import json
import re

import numpy as np
import pytest
import torch

from distributed_raytracer_tpu.utils import profiling as jprofiling
from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.tools import kernel_ab, schedule_frames
from distributed_raytracer_tpu_torch.utils import profiling, scenes

FRAMES = 2


def hand_trace() -> list:
    """Chrome trace events of a FRAMES-frame window, times in us. Device
    work: [200, 350] (two overlapping kernels, K1 and K2), [360, 400]
    (another kernel), [600, 650] (a copy): busy 240 of 1000. Idle gaps:
    [650, 1000] under cudaStreamSynchronize, [0, 200] under aten::index,
    [400, 600] under aten::copy_, [350, 360] under the frame's
    annotation. Four launch calls (two kernels, a graph, a copy)."""
    x = lambda cat, name, ts, dur: {"ph": "X", "cat": cat, "name": name,
                                    "ts": ts, "dur": dur, "pid": 1, "tid": 1}
    return [
        x("user_annotation", "frame", 0, 1000),
        x("cpu_op", "aten::index", 100, 50),
        x("cuda_runtime", "cudaLaunchKernel", 110, 5),
        x("cuda_runtime", "cudaLaunchKernel", 120, 5),
        x("cuda_runtime", "cudaGraphLaunch", 300, 10),
        x("cpu_op", "aten::copy_", 400, 200),
        x("cuda_runtime", "cudaMemcpyAsync", 560, 5),
        x("cuda_runtime", "cudaStreamSynchronize", 700, 290),
        x("kernel", "void nearest_chunk_kernel<4, true>(Args)", 200, 100),
        x("kernel", "void any_chunk_kernel<4, true>(Args)", 250, 100),
        x("kernel", "void at::native::elementwise_kernel<128, 4>(F)", 360,
          40),
        x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 600, 50),
        {"ph": "s", "cat": "ac2g", "name": "flow", "ts": 115, "id": 1},
    ]


def test_anatomy_of_a_known_trace():
    a = profiling.anatomy(hand_trace(), FRAMES)
    assert a["busy"] == pytest.approx(0.24)
    assert a["window_ms"] == pytest.approx(0.5)
    assert a["device_ms"] == pytest.approx({"K1": 0.05, "K2": 0.05,
                                            "other": 0.02})
    assert a["launches"] == pytest.approx({"K1": 0.5, "K2": 0.5,
                                           "other": 0.5})
    assert a["copy_ms"] == pytest.approx(0.025)
    assert a["kernels"] == pytest.approx(1.5)
    assert a["host_launch_calls"] == pytest.approx(2.0)
    assert [(g["ms"], g["at_ms"], g["host"], g["cat"]) for g in a["gaps"]] \
        == [(0.35, 0.65, "cudaStreamSynchronize", "cuda_runtime"),
            (0.2, 0.0, "aten::index", "cpu_op"),
            (0.2, 0.4, "aten::copy_", "cpu_op"),
            (0.01, 0.35, "frame", "user_annotation")]
    name = "void nearest_chunk_kernel<4, true>(Args)"
    assert a["by_name"][name] == (pytest.approx(0.05), 1)


def test_kernel_classes():
    names = {"void nearest_chunk_kernel<4, true>(x)": "K1",
             "void seed_keys<true, false>(x)": "K1",
             "void any_chunk_kernel<4, true>(x)": "K2",
             "void nearest_chunk_kernel<4, false>(x)": "K3n",
             "void any_chunk_kernel<4, false>(x)": "K3a",
             "void nearest_mxu_chunk_kernel<64, 8, 2>(x)": "K4",
             "void any_mxu_chunk_kernel<64, 8, 3>(x)": "K5",
             "void ring_nearest_chunks<4>(x)": "K6",
             "void ring_seed_keys(x)": "K6",
             "void ring_any_chunks<4>(x)": "K7",
             "Memcpy DtoD (Device -> Device)": "other"}
    for name, k in names.items():
        assert profiling.kernel_class(name) == k, name
    assert kernel_ab.kernel_class is not None
    assert kernel_ab.kernel_class(
        "void any_chunk_kernel<4, true>(x)") == "K2"


def _old_parse(events, n):
    """What tools/kernel_ab._profile and tools/schedule_frames.profile
    computed from a trace before they shared anatomy()."""
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    window = (max(e["ts"] + e["dur"] for e in events)
              - min(e["ts"] for e in events))
    per = {}
    for e in dev:
        k = profiling.kernel_class(e["name"])
        per[k] = per.get(k, 0.0) + e["dur"] / 1e3 / n
    launches, dev_ms = {}, {}
    for e in dev:
        if e.get("cat") == "kernel":
            k = profiling.kernel_class(e["name"])
            launches[k] = launches.get(k, 0) + 1 / n
            dev_ms[k] = dev_ms.get(k, 0.0) + e["dur"] / 1e3 / n
    kernels = sum(e.get("cat") == "kernel" for e in dev) / n
    host = sum(e.get("cat") == "cuda_runtime"
               and re.search(r"LaunchKernel|GraphLaunch|Memcpy|Memset",
                             e.get("name", "")) is not None
               for e in events) / n
    return (busy / window, per, kernels, host,
            {"busy": busy / window,
             "launches": {k: round(v, 2) for k, v in sorted(launches.items())},
             "device_ms": {k: round(v, 4) for k, v in sorted(dev_ms.items())},
             "host_launch_calls": host})


def test_tools_parse_as_before(monkeypatch):
    events = [e for e in hand_trace() if "dur" in e]
    fake = lambda fn, n: hand_trace()
    monkeypatch.setattr(kernel_ab.profiling, "profile_events", fake)
    monkeypatch.setattr(profiling, "profile_events", fake)
    busy, per, kernels, host, frames = _old_parse(events, FRAMES)
    got = kernel_ab._profile(lambda: None, FRAMES)
    assert got[0] == pytest.approx(busy)
    assert got[1] == pytest.approx(per) and set(got[1]) == set(per)
    assert got[2:] == pytest.approx((kernels, host))
    assert schedule_frames.profile(lambda: None, FRAMES) == frames


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.ones(64, 64)
    with profiling.trace(str(tmp_path / "t")) as t:
        for _ in range(3):
            (x @ x).sum()
    assert t.path.endswith(".json") and profiling.find_trace(
        str(tmp_path)) == t.path
    with open(t.path) as f:
        assert "traceEvents" in json.load(f)
    events = profiling.load_events(str(tmp_path))
    assert any(e.get("cat") == "cpu_op" and e["name"] == "aten::mm"
               for e in events)
    a = profiling.anatomy(events, 3)
    assert a["busy"] == 0.0 and a["kernels"] == 0 and a["gaps"]
    with pytest.raises(FileNotFoundError):
        profiling.find_trace(str(tmp_path / "none"))


@pytest.mark.parametrize("cells", [(1_000, 2_000), (200_000, 150_000)])
def test_frame_work_matches_jax(cells):
    kw = dict(rays=640 * 480, ray_tile=256, tri_block=128, seconds=0.05)
    want = jprofiling.FrameWork(*cells, **kw)
    got = profiling.FrameWork(*cells, **kw)
    assert got.pairs == want.pairs and isinstance(got.pairs, int)
    assert got.gpairs_per_sec == want.gpairs_per_sec
    wide = profiling.FrameWork(*(np.int32(c) for c in cells), **kw)
    assert wide.pairs == sum(cells) * 256 * 128
    if cells[0] > 10_000:
        assert got.pairs > 2 ** 31
    assert got.sol_fraction == pytest.approx(
        got.gpairs_per_sec / (67e12 / 21 / 1e9))
    assert "of the H100 roofline" in got.report()


def test_h100_rooflines():
    assert profiling.sol_gpairs() == pytest.approx(67e12 / 21 / 1e9)
    assert profiling.sol_gpairs(use_mxu=True) == pytest.approx(
        min(495e12 / 54, 67e12 / 6) / 1e9)
    ms, by = profiling.bound_ms(10 ** 9, True, 1000)
    assert by == "operations" and ms == pytest.approx(21e9 / 67e12 * 1e3)
    ms, by = profiling.bound_ms(10 ** 9, False, 1000)
    assert by == "operations" and ms == pytest.approx(39e9 / 67e12 * 1e3)
    ms, by = profiling.bound_ms(1, False, 3.35e9)
    assert by == "bytes" and ms == pytest.approx(1.0)
    b = profiling.mxu_bounds(10 ** 9)
    assert b["tensor"] == pytest.approx(54e9 / 495e12 * 1e3)
    assert b["issued"] == pytest.approx(144e9 / 495e12 * 1e3)


def test_orbit_work_averages_exact_frames():
    """orbit_work counts each frozen frame's finest cells (equal to its
    sync render's) averaged over the cameras, and refuses frames that
    overflowed their buckets."""
    scene = scenes.icosphere_scene(4)
    r = CulledRenderer(scene, 128, 96, device="cpu", block_size=64,
                       cull_group=2)
    away = scene.camera.yaw(3.14159)
    cams = [scene.camera, scene.camera.yaw(0.1)]
    r.render(away)
    r.freeze(away, margin=1.0)
    with pytest.raises(ValueError, match="overflowed"):
        profiling.orbit_work(r, cams, 1.0)
    cells = []
    for cam in cams:
        r.render_fast(cam, verify=True)
        r.render(cam)
        cells.append(r._last_counts[r.n_levels - 1] + r._last_counts[-1])
    work = profiling.orbit_work(r, cams, 0.5)
    assert work.pairs == sum(cells) / 2 * r.rt * r.tb > 0
    assert work.seconds == 0.5 and work.sol_gpairs == profiling.SOL_GPAIRS_SHARED

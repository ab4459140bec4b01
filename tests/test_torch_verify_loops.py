"""The port's verify loops check the frame of their last refreeze.

Every frozen renderer's verify loop renders, compares the reported work-list
counts with its buckets, refreezes (grow-only) and renders again, at most 8
times. The frame the eighth refreeze renders is the one the caller gets, so
the loop must check ITS counts before warning that it did not converge.

Each case drives a real renderer's loop with a stand-in frame whose counts
overflow the current buckets on the first `k` frames and fit them from then
on: with k = 8 (the first frame and the frames of the first 7 refreezes
overflow, the eighth refreeze's frame fits) nothing is logged; with k = 9
the last frame still overflows and the loop warns. Loops: CulledRenderer's
render_fast (ops/render_bvh.py) and freeze_bounced's render, the bands'
(parallel/render_sharded_bvh.py), the culled ring's
(parallel/ring_bvh.py) and the culled halo's (parallel/halo_bvh.py).
"""

import logging

import pytest
import torch

from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
from distributed_raytracer_tpu_torch.parallel import (halo_bvh,
                                                      render_sharded_bvh,
                                                      ring_bvh)
from distributed_raytracer_tpu_torch.utils import scenes

W, H = 32, 24
LOOPS = ["render_fast", "freeze_bounced", "bands", "ring", "halo"]


@pytest.fixture(scope="module")
def scene():
    return scenes.icosphere_scene(1)


class Frames:
    """A stand-in frame: counts = the current buckets (in the loop's count
    layout) plus 1 on the first `over` frames, the buckets themselves
    after."""

    def __init__(self, over: int):
        self.over, self.calls = over, 0

    def counts(self, pads: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        return pads + int(self.calls <= self.over)


def drive(loop: str, scene, frames: Frames):
    """Runs `loop`'s verify on `frames`; returns the value it returned."""
    cam = scene.camera
    if loop == "render_fast":
        r = CulledRenderer(scene, W, H, device="cpu")
        r.render(cam, block=True)
        r.freeze(cam)
        frame = lambda pads: (torch.zeros(1),
                              frames.counts(torch.tensor(pads)))
        return r._render_frozen(frame, cam, True, "render_fast")
    if loop == "freeze_bounced":
        r = CulledRenderer(scene, W, H, device="cpu")
        render = r.freeze_bounced(cam, 1)
        r._frozen_frame = lambda kind, inputs, body: lambda pads: (
            torch.zeros(1), frames.counts(torch.tensor(pads)))
        return render(cam, verify=True)
    if loop == "bands":
        r = render_sharded_bvh.make_sharded_culled_renderer(
            scene, W, H, mesh=["cpu"] * 2)
        r.device_fn = lambda c: (torch.zeros(H, W, 3), frames.counts(
            torch.tensor(r.buckets())[None].expand(2, -1)))
        return r(cam, verify=True)
    if loop == "ring":
        r = ring_bvh.RingCulledRenderer(scene, W, H, mesh=["cpu"] * 2)

        def dispatch(camera, diff=None):
            pads = torch.tensor([list(p + q) + [0, 0] for p, q in
                                 zip(r.w_pads, r.w_pads_sh)])
            return (torch.zeros(3, r.n_pad_ext),
                    frames.counts(pads[None].expand(2, -1, -1)))
    else:
        r = halo_bvh.HaloCulledRenderer(scene, W, H, mesh=["cpu"] * 2)

        def dispatch(camera, diff=None):
            pads = torch.tensor(r.w_pads[0] + r.w_pads_sh[0])
            return (torch.zeros(3, r.n_pad_ext),
                    frames.counts(pads[None].expand(2, -1)))
    r.device_fn = dispatch
    return r.render(cam, verify=True)


@pytest.mark.parametrize("loop", LOOPS)
def test_verify_accepts_the_eighth_refreezes_frame(loop, scene, caplog):
    frames = Frames(over=8)
    with caplog.at_level(logging.WARNING):
        drive(loop, scene, frames)
    assert frames.calls == 9              # the first frame + 8 refreezes
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]


@pytest.mark.parametrize("loop", LOOPS)
def test_verify_warns_when_the_last_frame_overflows(loop, scene, caplog):
    frames = Frames(over=9)
    with caplog.at_level(logging.WARNING):
        drive(loop, scene, frames)
    assert frames.calls == 9
    assert any("did not converge in 8 rounds" in r.getMessage()
               for r in caplog.records if r.levelno == logging.WARNING)

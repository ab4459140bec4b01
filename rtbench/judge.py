"""Whether the displayed frames are right: each sampled frame against the
plain reference's frame at the same pose.

The numbers compared, each the worst over the sampled frames:
  - "bad_share": the share of the frame's continuity pixels (whose 3x3
    neighbourhood shares the reference's decision: the object hit and the
    lights that light it) where some channel differs from the reference's
    by more than TOL levels of 255 (3: the repository's golden-image
    tolerance, tests/test_render_golden.py's channel_tol);
  - "mean_abs": the mean absolute difference over every pixel and
    channel, in levels of 255 (discontinuities included).
A configuration's "check" object sets how many frames a run samples
("frames") and each number's limit ("limits").
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench import reference

TOL = 3


def reference_frame(acc, pose, width: int, height: int,
                    ar: reference.Arith = reference.Arith()):
    """(rgb uint8 (H, W, 3), decision code (H, W)) on acc's device."""
    dev = acc.soup.p1.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    rgb, code = reference.render(acc, pose, width, height, ys.reshape(-1),
                                 xs.reshape(-1), ar)
    return rgb.view(height, width, 3), code.view(height, width)


def compare(got, want, code) -> dict:
    """The numbers of one frame: got and want uint8 (H, W, 3) tensors on
    one device, code the reference's decision codes."""
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    smooth = reference.continuity(code)
    bad = (diff.amax(-1) > TOL) & smooth
    return {"bad_share": float(bad.sum()) / max(int(smooth.sum()), 1),
            "mean_abs": float(diff.to(torch.float64).mean())}


def judge(acc, frames: dict, poses: dict, width: int, height: int) -> dict:
    """The worst numbers over the sampled frames (frame index -> uint8
    (H, W, 3) array or tensor) against the reference at their poses."""
    dev = acc.soup.p1.device
    worst = {"bad_share": 0.0, "mean_abs": 0.0}
    for idx in sorted(frames):
        want, code = reference_frame(acc, poses[idx], width, height)
        got = frames[idx]
        if not isinstance(got, torch.Tensor):
            got = torch.as_tensor(np.asarray(got))
        got = got.to(dev)
        for k, v in compare(got, want, code).items():
            worst[k] = max(worst[k], v)
    worst["frames"] = len(frames)
    return worst

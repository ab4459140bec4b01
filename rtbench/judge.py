"""Whether the displayed frames are right: each sampled frame against the
plain reference's frame at the same pose and the same scene (where the
traffic moves the scene, the reference's own hierarchy is built anew for
each distinct state of the sampled frames, from the SceneSpec's float64
triangles moved by the state: nothing of the program's fold).

The numbers compared, each the worst over the sampled frames:
  - "bad_share": the share of the frame's continuity pixels (whose 3x3
    neighbourhood shares the reference's decision: the object hit and the
    lights that light it) where some channel differs from the reference's
    by more than TOL levels of 255 (3: the repository's golden-image
    tolerance, tests/test_render_golden.py's channel_tol);
  - "mean_abs": the mean absolute difference over every pixel and
    channel, in levels of 255 (discontinuities included).
A configuration's "check" object sets how many frames a run samples
("frames") and each number's limit ("limits"). Its optional "bounces" (a
whole number >= 0; absent: 0) is the depth of Whitted reflection bounces
the reference draws, and with it the decision code folds in every
bounce's (reference.render).
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench import reference

TOL = 3


def _key(state):
    return None if state is None else (state.offsets.tobytes(),
                                       state.lights.tobytes())


def bounces(config: dict) -> int:
    """The reflection depth a configuration asks the reference for."""
    depth = config.get("bounces", 0)
    if not isinstance(depth, int) or isinstance(depth, bool) or depth < 0:
        raise ValueError(f"bounces {depth!r}: a whole number >= 0")
    return depth


class Reference:
    """The plain reference of one SceneSpec on one device, drawing
    `bounces` reflection bounces: `at(state)` is its hierarchy at a scene
    state (None: the scene as made), built when asked for; the last one is
    kept."""

    def __init__(self, scene, device, bounces: int = 0):
        self.scene, self.device, self.bounces = scene, device, bounces
        self._key, self._acc = (), None

    def at(self, state) -> reference.Accel:
        key = _key(state)
        if self._acc is None or key != self._key:
            self._acc = None
            self._acc = reference.build(reference.soup(self.scene,
                                                       self.device, state))
            self._key = key
        return self._acc


def by_state(frames, states: dict) -> list:
    """The frame indices, those of one state together (states in the order
    their first frame comes)."""
    order = {}
    for idx in sorted(frames):
        order.setdefault(_key(states.get(idx)), []).append(idx)
    return [idx for group in order.values() for idx in group]


def reference_frame(acc, pose, width: int, height: int,
                    ar: reference.Arith = reference.Arith(),
                    bounces: int = 0):
    """(rgb uint8 (H, W, 3), decision code (H, W)) on acc's device."""
    dev = acc.soup.p1.device
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    rgb, code = reference.render(acc, pose, width, height, ys.reshape(-1),
                                 xs.reshape(-1), ar, bounces)
    return rgb.view(height, width, 3), code.view(height, width)


def compare(got, want, code) -> dict:
    """The numbers of one frame: got and want uint8 (H, W, 3) tensors on
    one device, code the reference's decision codes."""
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs()
    smooth = reference.continuity(code)
    bad = (diff.amax(-1) > TOL) & smooth
    return {"bad_share": float(bad.sum()) / max(int(smooth.sum()), 1),
            "mean_abs": float(diff.to(torch.float64).mean())}


def judge(ref: Reference, frames: dict, poses: dict, states: dict,
          width: int, height: int) -> dict:
    """The worst numbers over the sampled frames (frame index -> uint8
    (H, W, 3) array or tensor) against the reference at their poses and
    states (frame index -> State or None)."""
    dev = torch.device(ref.device)
    worst = {"bad_share": 0.0, "mean_abs": 0.0}
    for idx in by_state(frames, states):
        want, code = reference_frame(ref.at(states.get(idx)), poses[idx],
                                     width, height, bounces=ref.bounces)
        got = frames[idx]
        if not isinstance(got, torch.Tensor):
            got = torch.as_tensor(np.asarray(got))
        got = got.to(dev)
        for k, v in compare(got, want, code).items():
            worst[k] = max(worst[k], v)
    worst["frames"] = len(frames)
    return worst

"""One CulledRenderer on one card drawing Whitted reflection bounces: the
program's bounced main path.

The CLI's `--mode culled --bounces N` (run.py): the renderer is built from
the scene (the program bakes it) with the configuration's "renderer"
keyword arguments and sized by `freeze_bounced(camera, depth)` at the
scene's camera, which runs one sync `render_bounced` and fixes per-bounce
buckets; each frame is one replay of that frozen render. The depth is the
configuration's "bounces". The scene does not move: a scene state other
than None is refused.

Every bounce's nearest query runs the per-ray-origin kernel (K3n), bounce
0's primary rays included, and every bounce's shadow query the
shared-origin any-hit kernel (K2): the layout's TRAVERSAL names the kernel
classes each replay of the frame runs, which devtrace checks a traced
window by (K1 and K2 for a layout without it).
"""

from __future__ import annotations

import numpy as np
import torch


class Bounced:
    TRAVERSAL = ("K3n", "K2")

    def __init__(self, scene, config: dict, device: str, cards: int):
        from distributed_raytracer_tpu_torch.ops.render_bvh import (
            CulledRenderer)

        dev = torch.device(device if device == "cpu" else "cuda:0")
        self.cards = [dev]
        self.width, self.height = config["width"], config["height"]
        self.depth = int(config["bounces"])
        self.r = CulledRenderer(scene, config["width"], config["height"],
                                device=dev, **config["renderer"])
        self.frozen = self.r.freeze_bounced(scene.camera, self.depth)
        self._rows = (None, None)

    def render(self, cam, verify: bool, state=None):
        if state is not None:
            raise ValueError("the bounced layout does not move the scene")
        return self.frozen(cam, verify)

    def frame_streams(self):
        """(stream a frame starts on, stream it ends on) per card."""
        s = torch.cuda.current_stream(self.cards[0])
        return [(s, s)]

    def _counts(self, cams, states) -> list:
        """Each camera's per-bounce counts (render_bounced's
        `_last_bounce_counts`: per bounce, the counts layout of render()),
        from one sync render_bounced of each; kept for the last cameras,
        so pairs and ray_pairs of one frame list render each once."""
        if any(s is not None for s in states or ()):
            raise ValueError("the bounced layout does not move the scene")
        key = [np.concatenate([c.pos, c.forward, c.left, c.up,
                               [c.fov]]).tobytes() for c in cams]
        if self._rows[0] != key:
            rows = []
            for cam in cams:
                self.r.render_bounced(cam, self.depth)
                rows.append(self.r._last_bounce_counts)
            self._rows = (key, rows)
        return self._rows[1]

    def pairs(self, cams, states=None) -> list:
        """Scheduled shared-origin (ray, triangle) pairs of each camera's
        frame: every bounce's finest shadow cells times the ray tile and
        the block (single.py's rule), which K2 runs."""
        r = self.r
        return [sum(row[-1] for row in frame) * r.rt * r.tb
                for frame in self._counts(cams, states)]

    def ray_pairs(self, cams, states=None) -> list:
        """Scheduled per-ray-origin pairs of each camera's frame: every
        bounce's finest nearest-query cells times the ray tile and the
        block, which K3n runs."""
        r = self.r
        return [sum(row[r.n_levels - 1] for row in frame) * r.rt * r.tb
                for frame in self._counts(cams, states)]

    def release(self):
        self.r.release_graphs()
        self.r = self.frozen = None


def build(scene, config: dict, device: str, cards: int):
    return Bounced(scene, config, device, cards)

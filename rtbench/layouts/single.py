"""One CulledRenderer on one card: the program's main path.

The configuration's "renderer" object holds CulledRenderer's keyword
arguments. The renderer is built from the scene (the program bakes it),
sized by a sync render at the scene's camera and frozen, as the CLI's
culled mode builds it (run.py); each frame is render_fast, one replay of
its frozen graph. The scene does not move: a scene state other than None
is refused.
"""

from __future__ import annotations

import torch


class Single:
    def __init__(self, scene, config: dict, device: str, cards: int):
        from distributed_raytracer_tpu_torch.ops.render_bvh import (
            CulledRenderer)

        dev = torch.device(device if device == "cpu" else "cuda:0")
        self.cards = [dev]
        self.width, self.height = config["width"], config["height"]
        self.r = CulledRenderer(scene, config["width"], config["height"],
                                device=dev, **config["renderer"])
        self.r.render(scene.camera, block=True)
        self.r.freeze(scene.camera)

    def render(self, cam, verify: bool, state=None):
        if state is not None:
            raise ValueError("the single layout does not move the scene")
        return self.r.render_fast(cam, verify=verify)

    def frame_streams(self):
        """(stream a frame starts on, stream it ends on) per card."""
        s = torch.cuda.current_stream(self.cards[0])
        return [(s, s)]

    def pairs(self, cams, states=None) -> list:
        """Scheduled (ray, triangle) pairs of each camera's frame: the
        finest primary and shadow cells of its frozen counts times the ray
        tile and the block. Each camera is rendered with verify=True first,
        so no count is an overflowed one."""
        if any(s is not None for s in states or ()):
            raise ValueError("the single layout does not move the scene")
        r = self.r
        for cam in cams:
            r.render_fast(cam, verify=True)
        _, counts = r.render_many(cams)
        rows = counts.cpu().tolist()
        return [(row[r.n_levels - 1] + row[-1]) * r.rt * r.tb
                for row in rows]

    def release(self):
        self.r.release_graphs()
        self.r = None


def build(scene, config: dict, device: str, cards: int):
    return Single(scene, config, device, cards)

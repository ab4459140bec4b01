"""One DynamicCulledRenderer on one card: the program's scene-diff path.

The CLI's `--animate-objects` culled mode (run.py): the renderer is built
from the scene (the program's grouped bake), sized by a sync render at the
scene's camera and frozen; each frame is render_dynamic with the frame's
SceneDiff (the objects' positions and the lights), which the program folds
into its device arrays inside the frame's graph. The configuration's
"renderer" object holds DynamicCulledRenderer's keyword arguments.

MOVES: the scene state of render(camera, verify, state) is a
reference.State (each object's offset from its position in the scene,
float64, and the lights' positions); with None the frame is the scene as
made.
"""

from __future__ import annotations

import numpy as np
import torch

MOVES = True


class Dynamic:
    def __init__(self, scene, config: dict, device: str, cards: int):
        from distributed_raytracer_tpu_torch.ops.render_dynamic import (
            DynamicCulledRenderer)

        dev = torch.device(device if device == "cpu" else "cuda:0")
        self.cards = [dev]
        self.width, self.height = config["width"], config["height"]
        self.r = DynamicCulledRenderer(scene, config["width"],
                                       config["height"], device=dev,
                                       **config["renderer"])
        self.r.render(scene.camera, block=True)
        self.r.freeze(scene.camera)
        self.baked = np.stack([o.pos for o in scene.objects])
        self.made = scene.make_diff()

    def diff(self, state):
        """The program's SceneDiff of a scene state (None: as made)."""
        from distributed_raytracer_tpu_torch.models.scene import SceneDiff

        if state is None:
            return self.made
        return SceneDiff(
            obj_pos=(self.baked + state.offsets).astype(np.float32),
            light_pos=np.asarray(state.lights, np.float32),
            light_col=self.made.light_col)

    def render(self, cam, verify: bool, state=None):
        return self.r.render_dynamic(cam, self.diff(state), verify)

    def frame_streams(self):
        """(stream a frame starts on, stream it ends on) per card."""
        s = torch.cuda.current_stream(self.cards[0])
        return [(s, s)]

    def pairs(self, cams, states=None) -> list:
        """Scheduled (ray, triangle) pairs of each frame at its camera and
        scene state: the finest primary and shadow cells of its verified
        counts times the ray tile and the block."""
        from distributed_raytracer_tpu_torch.ops import frozen_graph

        r, out = self.r, []
        for cam, state in zip(cams, states or [None] * len(cams)):
            with frozen_graph.deferred() as checks:
                self.render(cam, True, state)
            frozen_graph.settle(checks)
            row = checks[0].counts.cpu().tolist()
            out.append((row[r.n_levels - 1] + row[-1]) * r.rt * r.tb)
        return out

    def release(self):
        self.r.release_graphs()
        self.r = None


def build(scene, config: dict, device: str, cards: int):
    return Dynamic(scene, config, device, cards)

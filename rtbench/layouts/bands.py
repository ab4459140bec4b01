"""Equal horizontal bands, one per card, in one process: the program's
frame across cards (parallel/render_sharded_bvh.py).

Rank i renders rows [i * ceil(H / n), (i + 1) * ceil(H / n)) on cuda:i
(parallel/mesh.make_mesh), every rank from one bake of the whole scene
with its own frozen graph on its own stream, and the bands are gathered
to card 0 and assembled there. The cell's chips set n. The scene does not
move: a scene state other than None is refused.
"""

from __future__ import annotations

import torch


class Bands:
    def __init__(self, scene, config: dict, device: str, cards: int):
        from distributed_raytracer_tpu_torch.parallel import mesh as mesh_mod
        from distributed_raytracer_tpu_torch.parallel import (
            render_sharded_bvh)

        n = cards
        mesh = mesh_mod.make_mesh(n, "cpu" if device == "cpu" else "cuda")
        self.cards = list(mesh)
        self.width, self.height = config["width"], config["height"]
        self.br = render_sharded_bvh.make_sharded_culled_renderer(
            scene, config["width"], config["height"], mesh=mesh,
            sizing_camera=scene.camera)

    def render(self, cam, verify: bool, state=None):
        if state is not None:
            raise ValueError("the bands layout does not move the scene")
        return self.br(cam, verify=verify)

    def frame_streams(self):
        """Per card: its rank's compute stream, where its band starts, and
        the card's current stream, where its part of the gather ends."""
        ranks = self.br.ranks
        return [(ranks.compute[r], torch.cuda.current_stream(d))
                for r, d in enumerate(self.cards)]

    def pairs(self, cams, states=None) -> list:
        """Scheduled pairs of each camera's frame, summed over the bands
        (each band's finest primary and shadow cells of the frame's
        verified counts, times its ray tile and block)."""
        if any(s is not None for s in states or ()):
            raise ValueError("the bands layout does not move the scene")
        out = []
        for cam in cams:
            self.br(cam, verify=True)
            counts = self.br.last_counts.cpu().tolist()
            total = 0
            for band, row in zip(self.br.bands, counts):
                total += ((row[band.n_levels - 1] + row[-1])
                          * band.rt * band.tb)
            out.append(total)
        return out

    def release(self):
        for band in self.br.bands:
            band.release_graphs()
        self.br = None


def build(scene, config: dict, device: str, cards: int):
    return Bands(scene, config, device, cards)

"""Single-device dense frame rendering: ray gen -> nearest hit -> shade.

The torch counterpart of distributed_raytracer_tpu/ops/render.py: every
pixel's ray is tested against every triangle (the per-pixel double loop of
the reference's sequential worker, worker/sequential/main.go:15-32, as one
batched program), chunked over rays at `cfg.ray_chunk` so a chunk's
(C, T) arrays stay bounded on the device. The JAX package pads the last
chunk with dummy rays; here the last chunk is just shorter (same pixels).

`scene` is a SceneArrays of tensors on one device (`scene_on`); the frame
comes back as an (H, W, 3) float32 tensor on that device.
"""

from __future__ import annotations

import torch

from distributed_raytracer_tpu_torch.models.scene import SceneArrays
from distributed_raytracer_tpu_torch.ops import intersect, raygen, shade
from distributed_raytracer_tpu_torch.ops.intersect import _dot3
from distributed_raytracer_tpu_torch.utils.config import (DEFAULT_CONFIG,
                                                          RenderConfig)


def scene_on(arrays: SceneArrays, device) -> SceneArrays:
    """SceneArrays of numpy arrays or tensors -> tensors on `device`
    (fields already there are not copied)."""
    return SceneArrays(*(torch.as_tensor(a).to(device) for a in arrays))


def trace_rays(scene: SceneArrays, cam_pos: torch.Tensor,
               origins: torch.Tensor, dirs: torch.Tensor,
               cfg: RenderConfig = DEFAULT_CONFIG,
               table: torch.Tensor | None = None) -> torch.Tensor:
    """Trace + shade a flat batch of rays (C, 3) -> colours (C, 3).
    `table` is shade.pack_table(scene), built here when not given."""
    hits = intersect.nearest_hit(scene, origins, dirs)
    return shade.shade(scene, cam_pos, origins, dirs, hits, cfg, table)


def trace_rays_bounced(scene: SceneArrays, origins: torch.Tensor,
                       dirs: torch.Tensor, depth: int,
                       cfg: RenderConfig = DEFAULT_CONFIG,
                       table: torch.Tensor | None = None) -> torch.Tensor:
    """Whitted-style multi-bounce specular tracing: colour = sum_b
    (prod_{i<b} Ks_i) * phong_b, clamped to [0, 1] at the end. Each
    bounce's specular viewer is the previous hit point; reflected rays
    leave the surface with the shadow rays' normal lift and exclude their
    originating triangle."""
    if table is None:
        table = shade.pack_table(scene)
    c = dirs.shape[0]
    colour = dirs.new_zeros((c, 3))
    throughput = dirs.new_ones((c, 3))
    view, o, d, exclude = origins, origins, dirs, None

    for bounce in range(depth + 1):
        hits = intersect.nearest_hit(scene, o, d, exclude=exclude)
        prep = shade.prepare(scene, o, d, hits, cfg, table)
        q = prep.queries
        lit = [~intersect.any_hit(scene, q.origin[li], q.ldir[li],
                                  q.t_max[li], exclude=hits.tri)
               for li in range(q.origin.shape[0])]
        lit = (torch.stack(lit) if lit
               else torch.zeros((0, c), dtype=torch.bool, device=d.device))
        local = shade.shade_core(scene, view, prep, hits, lit)
        colour = colour + throughput * local  # local is 0 for misses

        if bounce == depth:
            break
        throughput = torch.where(hits.valid[:, None], throughput * prep.ks,
                                 0.0)
        n = prep.normal
        refl = d - 2.0 * _dot3(d, n)[:, None] * n
        side = torch.where(_dot3(n, refl) >= 0.0, 1.0, -1.0)
        view = prep.x
        o = (prep.x + cfg.shadow_offset * refl
             + (cfg.shadow_normal_offset * side)[:, None] * n)
        d = refl / torch.sqrt(_dot3(refl, refl))[:, None]
        exclude = hits.tri

    return torch.clamp(colour, 0.0, 1.0)


def _chunks(n: int, ray_chunk: int):
    chunk = min(ray_chunk, n)
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def render_frame(scene: SceneArrays, cam, width: int, height: int,
                 cfg: RenderConfig = DEFAULT_CONFIG) -> torch.Tensor:
    """Render a full frame; returns (height, width, 3) float32 in [0, 1].
    `cam` is a Camera or CameraArrays (host or on the scene's device)."""
    dev = scene.p0.device
    intersect.fp32_matmuls(dev)
    cam = raygen.camera_arrays(cam, dev)
    dirs = raygen.ray_directions(cam, width, height).reshape(-1, 3)
    table = shade.pack_table(scene)
    colours = torch.cat([trace_rays(scene, cam.pos, cam.pos, dirs[s:e], cfg,
                                    table)
                         for s, e in _chunks(dirs.shape[0], cfg.ray_chunk)])
    return colours.reshape(height, width, 3)


def render_frame_bounced(scene: SceneArrays, cam, width: int, height: int,
                         depth: int, cfg: RenderConfig = DEFAULT_CONFIG
                         ) -> torch.Tensor:
    """Multi-bounce render (see trace_rays_bounced); depth=0 ==
    render_frame."""
    dev = scene.p0.device
    intersect.fp32_matmuls(dev)
    cam = raygen.camera_arrays(cam, dev)
    dirs = raygen.ray_directions(cam, width, height).reshape(-1, 3)
    table = shade.pack_table(scene)
    colours = torch.cat([trace_rays_bounced(scene, cam.pos, dirs[s:e], depth,
                                            cfg, table)
                         for s, e in _chunks(dirs.shape[0], cfg.ray_chunk)])
    return colours.reshape(height, width, 3)

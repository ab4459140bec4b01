"""Configuration system.

The reference hard-codes every tunable as a compile-time constant (SURVEY.md §5
"Config / flag system"; master/main.go:25-35, pool.go:16-19, screen.go:10-13,
shared/state/util.go:7, tracer.go:64). Here they are promoted into a real,
overridable config object. Values keep the reference defaults so behaviour is
reproducible.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Tunables of the render engine and frame loop.

    Reference origins:
      shadow_offset   — tracer.go:64 (shadow-ray origin offset of 1e-4)
      bound_epsilon   — shared/state/util.go:7 (min AABB extent)
      move_step       — master/main.go:254 (camera move distance per frame)
      target_fps      — shared/screen/screen.go:11
      tile_width/height — master/main.go:25-28 (partition kernel, 50x50)
      frames_in_flight  — master/main.go:233-266 (pipelined coordinators;
                          the reference allows unbounded frames in flight,
                          ordered by a channel chain; we bound the queue)
      gimbal_nudge    — camera.go:96-127 (forward-vector nudge magnitude)
    """

    shadow_offset: float = 1e-4
    # float32-only robustness term with no reference equivalent: shadow-ray
    # origins are additionally lifted along the geometric normal, giving
    # clearance from the local surface plane that does not collapse at
    # grazing light angles (the reference's float64 precision makes its
    # 1e-4 along-light offset sufficient; float32's does not).
    shadow_normal_offset: float = 1e-3
    bound_epsilon: float = 1e-4
    move_step: float = 0.1
    target_fps: int = 30
    tile_width: int = 50
    tile_height: int = 50
    frames_in_flight: int = 2
    gimbal_nudge: float = 1e-4
    # Failure containment: after this many CONSECUTIVE dropped frames the
    # loop stops issuing work — the analog of the master's pool eviction
    # ending the run when no worker answers (pool.go:224-260). A transient
    # failure (one bad dispatch) just drops frames, like main.go:153-161.
    max_consecutive_drops: int = 30
    # Recovery: when a drop run hits max_consecutive_drops and the loop
    # has a `recover` hook, it rebuilds the render path and resumes — the
    # worker's idle-out -> re-register healing loop
    # (worker/distributed/main.go:160-185). After this many rebuilds the
    # loop gives up and aborts.
    max_recoveries: int = 3

    # Device tunables (no reference equivalent).
    ray_chunk: int = 8192          # rays per lax.map chunk in the dense path
    # BVH leaf block size lives on CulledRenderer(block_size=...): it sets
    # kernel shapes, so it is a per-renderer compile-time choice, not a
    # runtime config value; default_block_size() below records the
    # measured per-scene policy (CulledRenderer accepts block_size="auto").
    dtype: str = "float32"         # device compute dtype


DEFAULT_CONFIG = RenderConfig()


def default_block_size(n_tris: int) -> int:
    """Per-scene BVH leaf size policy, the JAX package's unchanged: 64-
    triangle leaves below a million triangles, 128 above. The JAX package
    measured the crossover on a TPU; it has not been measured on the H100
    yet."""
    return 64 if n_tris < 1_000_000 else 128

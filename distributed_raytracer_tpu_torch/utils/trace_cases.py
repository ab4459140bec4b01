"""Hard inputs for the CUDA-core traversal kernels (K1, K2 with a shared
origin; K3n, K3a with per-ray origins).

`edge_case_launch` builds one launch of `bsr_nearest` / `bsr_any` from a
seed, with numpy, aimed at the places where a kernel can round, order or
schedule differently from the plain versions:
  - two unit icospheres (subdivision 3) in front of each other, seen from
    an off-axis origin; rays aimed exactly at shared vertices and at points
    along shared edges (the BARY_EPS band of two or six triangles at once),
    grazing rays at the silhouette, rays through the faces, misses, and
    dead rays (zero direction);
  - with per-ray origins (shared_origin=False, static pack_tris rows), the
    origins spread around that one: a share exactly at it, a share jittered
    about it, and a share on triangles of the two spheres, lifted off the
    surface as ops/render_bvh.py `_reflect_from` lifts a reflection ray's
    origin, half of them along the mirrored direction, each excluding its
    own triangle (the bounce queries' case);
  - a copy of the most-hit triangle block (every hit in it ties at one t
    with a second id), a block whose two triangles contain the origin in
    their plane (every ray from that origin with d_z != 0 hits them at
    t = +0.0 or -0.0), and an all-zero block (den = 0 against every ray);
  - exclusion ids (a ray's own nearest triangle, random ids, none), a
    nonzero gid_base, finite init seeds (a whole tile, a share of rays,
    ties with the best hit), a tile seeded as hit, t_max at, below and
    above the nearest hit;
  - a tile-major work list with tiles of no item, one item, a few, all
    blocks, and more than 4 * chunk items (blocks repeat), and live-looking
    slots past `count`; `entry` is each item's least valid t, so the
    front-to-back skip (exit_every > 0) has real work and stays exact.
The nearest and any-hit launches share the rays (row 6 carries t_max).
With a shared origin the launch also comes in the tensor-core form (K4,
K5): the tuple (pack_dirs A, fold_origin_scal scalars) of the same rows,
with `ablock_ids`, for ORIGIN alone or with the scalars of a second origin
stacked after ORIGIN's over the one A (the all-lights shadow launch's
indexing: every other live item reads the second origin's scalars).
`ring_edge_case` turns the same rows and rays into one query of the ring's
step kernels (ops/ring_trace.py: K6, K7) over n ranks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import Scene, SceneObject
from distributed_raytracer_tpu_torch.ops import bsr_trace
from distributed_raytracer_tpu_torch.utils import scenes
from distributed_raytracer_tpu_torch.utils.config import DEFAULT_CONFIG

N_TILES = 8
ORIGIN = (0.31, -0.22, 3.4)
ORIGIN2 = (-0.45, 0.35, 3.1)  # the tensor-core form's second origin
GID_BASE = 5
_PAST_COUNT = 10  # live-looking slots past count


@dataclasses.dataclass
class EdgeCaseLaunch:
    rays: torch.Tensor       # (8, R): origins, directions, t_max
    exclude: torch.Tensor    # (R,) int32
    tris: torch.Tensor       # (T, 16) pack_tris_origin or pack_tris rows,
    #                          or the tuple (A (3T, 8), scal (S, 8))
    tile_ids: torch.Tensor   # (W,) int32
    block_ids: torch.Tensor  # (W,) int32
    entry: torch.Tensor      # (W,) float32
    count: torch.Tensor      # (1,) int32, < W
    init_t: torch.Tensor     # (R,) float32
    init_i: torch.Tensor     # (R,) int32
    init_hit: torch.Tensor   # (R,) int32, 0/1
    gid_base: torch.Tensor   # (1,) int32
    rt: int
    tb: int
    shared_origin: bool = True
    ablock_ids: torch.Tensor | None = None  # (W,) int32, the tuple form's

    @property
    def kwargs(self) -> dict:
        return {"rt": self.rt, "tb": self.tb,
                "shared_origin": self.shared_origin}

    def _ablock(self) -> tuple:
        return () if self.ablock_ids is None else (self.ablock_ids,)

    def nearest_args(self) -> tuple:
        return (self.rays, self.exclude, self.tris, self.tile_ids,
                self.block_ids, self.entry, self.count, self.init_t,
                self.init_i, self.gid_base) + self._ablock()

    def any_args(self) -> tuple:
        return (self.rays, self.exclude, self.tris, self.tile_ids,
                self.block_ids, self.entry, self.count, self.init_hit,
                self.gid_base) + self._ablock()

    def to(self, device) -> "EdgeCaseLaunch":
        def move(x):
            if isinstance(x, tuple):
                return tuple(move(a) for a in x)
            return x.to(device) if isinstance(x, torch.Tensor) else x
        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name))
            for f in dataclasses.fields(self)})

    def rows(self) -> torch.Tensor:
        """The (S, 16) pack_tris_origin rows of the launch: its tris, or,
        in the tuple form, scalar block b's (num, a_u, a_v) beside A block
        b mod n_blocks's directions (ablock_ids == block_ids mod n_blocks)."""
        if not isinstance(self.tris, tuple):
            return self.tris
        dirs, scal = self.tris
        tb = self.tb
        a = dirs.reshape(-1, 3, tb, 8)
        a = a[torch.arange(scal.shape[0] // tb) % a.shape[0]]
        rows = scal.new_zeros((scal.shape[0], 16))
        for k in range(3):
            rows[:, 4 * k:4 * k + 3] = a[:, k, :, 3:6].reshape(-1, 3)
            rows[:, 4 * k + 3] = scal[:, k]
        return rows

    def twin(self) -> "EdgeCaseLaunch":
        """The same launch in the (S, 16) form (K1, K2)."""
        return dataclasses.replace(self, tris=self.rows(), ablock_ids=None)

    def visited(self) -> torch.Tensor:
        """(R,) bool: rays of the tiles the live slots name."""
        n = int(self.count.item())
        v = torch.zeros(self.rays.shape[1] // self.rt, dtype=torch.bool,
                        device=self.rays.device)
        v[self.tile_ids[:n].long()] = True
        return v.repeat_interleave(self.rt)


def _two_spheres() -> Scene:
    base = scenes.icosphere_scene(3)
    mesh = base.meshes["ico"]
    return Scene(meshes={"ico": mesh},
                 objects=[SceneObject(1, "ico", np.zeros(3)),
                          SceneObject(2, "ico", np.array([0.7, 0.45, -2.2]))],
                 light_pos=base.light_pos, light_col=base.light_col,
                 camera=Camera.create(ORIGIN, [0.0, 0.0, -1.0], 1.0))


def _targets(rng, scene: Scene, n: int, o: np.ndarray) -> np.ndarray:
    """(n, 3) float64 ray directions from the origins o ((3,) shared or
    (n, 3)), by kind: shared vertices, points on shared edges, the
    silhouette (as seen from ORIGIN), faces, misses, dead."""
    o = np.broadcast_to(o, (n, 3))
    mesh = scene.meshes["ico"]
    verts = np.concatenate([mesh.vertices + obj.pos for obj in scene.objects])
    faces = np.concatenate([mesh.faces_v + k * len(mesh.vertices)
                            for k in range(len(scene.objects))])
    kind = rng.choice(6, size=n, p=[0.2, 0.25, 0.1, 0.3, 0.1, 0.05])
    d = np.zeros((n, 3))
    for k, m in enumerate(np.bincount(kind, minlength=6)):
        sel = kind == k
        if k == 0:                                   # shared vertices
            tgt = verts[rng.integers(0, len(verts), m)]
        elif k == 1:                                 # along shared edges
            f = faces[rng.integers(0, len(faces), m)]
            e = rng.integers(0, 3, m)
            a = verts[f[np.arange(m), e]]
            b = verts[f[np.arange(m), (e + 1) % 3]]
            frac = rng.choice([0.5, 1 / 3, 0.25, 0.0], size=m)
            frac = np.where(rng.uniform(size=m) < 0.25, rng.uniform(size=m),
                            frac)
            tgt = a + frac[:, None] * (b - a)
        elif k == 2:                                 # the silhouette
            nrm = mesh.vertices / np.linalg.norm(mesh.vertices, axis=1,
                                                 keepdims=True)
            v0 = mesh.vertices
            eye = np.asarray(ORIGIN)
            cos = np.einsum("ij,ij->i", nrm, eye - v0) / np.linalg.norm(
                eye - v0, axis=1)
            rim = v0[np.argsort(np.abs(cos))[:64]]
            tgt = rim[rng.integers(0, len(rim), m)]
        elif k == 3:                                 # through the faces
            f = faces[rng.integers(0, len(faces), m)]
            w = rng.dirichlet(np.ones(3), m)
            tgt = np.einsum("nk,nkj->nj", w, verts[f])
        elif k == 4:                                 # misses
            tgt = o[sel] + rng.normal(size=(m, 3)) + np.array([0, 0, 3.0])
        else:                                        # dead rays
            d[sel] = 0.0
            continue
        d[sel] = tgt - o[sel]
    unit = rng.uniform(size=n) < 0.5
    d[unit] /= np.maximum(np.linalg.norm(d[unit], axis=1, keepdims=True),
                          1e-30)
    return d


def _origin_plane_block(tb: int, shared_origin: bool) -> np.ndarray:
    """A block whose first two rows contain ORIGIN in their plane, u = v =
    0.25 for every ray: t = +-0.0 for a ray from ORIGIN wherever d_z != 0.
    Folded (shared origin): w = +0.0 and -0.0. Static rows (per-ray
    origins): the plane z = ORIGIN_z with normals +z and -z, k_u = k_v = 0,
    so num = +0.0 and t takes den's sign (other origins hit the plane at
    t = (ORIGIN_z - o_z) / d_z). The other rows are zero."""
    blk = np.zeros((tb, 16), np.float32)
    if shared_origin:
        for r, w in ((0, 0.0), (1, -0.0)):
            blk[r, :12] = [0, 0, 1, w, 1, 0, 0, 0.25, 0, 1, 0, 0.25]
    else:
        z = np.float32(ORIGIN[2])
        for r, s in ((0, 1.0), (1, -1.0)):
            blk[r, :12] = [0, 0, s, s * z, 0, 0, 0, 0.25, 0, 0, 0, 0.25]
    return blk


def _ray_origins(rng, arrays, n: int):
    """Per-ray origins: ((n, 3) float32-exact float64 origins, (n, 3)
    mirrored directions, (n,) own triangle index or -1). A share sits
    exactly at ORIGIN, a share is jittered about it, and a share lies on
    random triangles of the bake, lifted as `_reflect_from` lifts a
    reflection origin: the direction from ORIGIN mirrored about the
    geometric normal, the point moved shadow_offset along it and
    shadow_normal_offset along the normal on its side."""
    cfg = DEFAULT_CONFIG
    eye = np.asarray(ORIGIN)
    kind = rng.choice(3, size=n, p=[0.3, 0.35, 0.35])
    o = np.tile(eye, (n, 1))
    o[kind == 1] += rng.normal(scale=0.3, size=((kind == 1).sum(), 3))
    surf = kind == 2
    m = int(surf.sum())
    real = np.nonzero(np.abs(arrays.geo_n).sum(1) > 0)[0]
    own = np.full(n, -1)
    own[surf] = real[rng.integers(0, len(real), m)]
    w = rng.dirichlet(np.ones(3), m)
    f64 = lambda a: np.asarray(a, np.float64)[own[surf]]
    x = (f64(arrays.p0) + w[:, 1:2] * f64(arrays.e1)
         + w[:, 2:3] * f64(arrays.e2))
    nrm = f64(arrays.geo_n)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    din = x - eye
    din /= np.linalg.norm(din, axis=1, keepdims=True)
    refl = din - 2.0 * np.einsum("ij,ij->i", din, nrm)[:, None] * nrm
    refl /= np.linalg.norm(refl, axis=1, keepdims=True)
    side = np.where(np.einsum("ij,ij->i", nrm, refl) >= 0.0, 1.0, -1.0)
    o[surf] = (x + cfg.shadow_offset * refl
               + (cfg.shadow_normal_offset * side)[:, None] * nrm)
    mirror = np.zeros((n, 3))
    mirror[surf] = refl
    return o.astype(np.float32).astype(np.float64), mirror, own


def _dense_items(rays, exclude, tris, gid_base, rt, tb, shared_origin):
    """Per (tile, block) of every pair: (valid count, least valid t)."""
    n_tiles, n_blocks = rays.shape[1] // rt, tris.shape[0] // tb
    t_ids = torch.arange(n_tiles).repeat_interleave(n_blocks)
    b_ids = torch.arange(n_blocks).repeat(n_tiles)
    hits = torch.zeros(len(t_ids), dtype=torch.int64)
    least = torch.full((len(t_ids),), float("inf"))
    step = max(1, (1 << 22) // (rt * tb))
    for s in range(0, len(t_ids), step):
        e = min(s + step, len(t_ids))
        t, valid, _, _ = bsr_trace._pairs(
            rays, exclude, tris, t_ids[s:e], b_ids[s:e], b_ids[s:e],
            gid_base.long(), rt, tb, shared_origin)
        hits[s:e] = valid.sum(dim=(1, 2))
        least[s:e] = torch.where(valid, t, float("inf")).amin(dim=(1, 2))
    return hits.reshape(n_tiles, n_blocks), least.reshape(n_tiles, n_blocks)


def edge_case_launch(rt: int = 512, tb: int = 64, chunk: int | None = None,
                     seed: int = 0, shared_origin: bool = True,
                     mxu_origins: int = 0) -> EdgeCaseLaunch:
    """The launch, on the CPU (`.to(device)` moves it), in one origin form:
    shared (pack_tris_origin rows for ORIGIN) or per-ray (static pack_tris
    rows, origins from `_ray_origins`). `chunk` (default bsr_trace.CHUNK)
    sizes the heavy tile: more than 4 * chunk items. With mxu_origins 1 or
    2 (shared origin only) the triangles are the tensor-core tuple instead
    (`_tuple_form`)."""
    if mxu_origins not in (0, 1, 2):
        raise ValueError(f"mxu_origins={mxu_origins}: 0, 1 or 2")
    if mxu_origins and not shared_origin:
        raise ValueError("the tensor-core form implies a shared origin")
    chunk = bsr_trace.CHUNK if chunk is None else chunk
    rng = np.random.default_rng(seed)
    scene = _two_spheres()
    arrays = scene.bake()
    static = torch.from_numpy(bsr_trace.pack_tris(arrays))
    o = torch.tensor(ORIGIN, dtype=torch.float32)
    r = N_TILES * rt
    if shared_origin:
        rows = bsr_trace.pack_tris_origin(static, o).numpy()
        d = _targets(rng, scene, r, np.asarray(ORIGIN))
        own = np.full(r, -1)
    else:
        # Origins from a second stream: the shared form's draws stay as
        # they are.
        rows = static.numpy()
        o_rows, mirror, own = _ray_origins(
            np.random.default_rng([seed, 1]), arrays, r)
        d = _targets(rng, scene, r, o_rows)
        along = (own >= 0) & (np.random.default_rng([seed, 2]).uniform(
            size=r) < 0.5)
        d[along] = mirror[along]
        o = torch.from_numpy(o_rows.T.astype(np.float32)).contiguous()
    n_scene = rows.shape[0] // tb
    d = torch.from_numpy(d.astype(np.float32))
    gid_base = torch.tensor([GID_BASE], dtype=torch.int32)
    no_excl = torch.full((r,), -1, dtype=torch.int32)
    rays = bsr_trace.pack_rays_rows(o, d.T.contiguous())

    # The most-hit scene block, copied: its hits tie at one t with a
    # second id. Then the origin-plane block and an all-zero block.
    hits, _ = _dense_items(rays, no_excl, torch.from_numpy(rows), gid_base,
                           rt, tb, shared_origin)
    busy = int(hits.sum(0).argmax())
    dup, plane, zero = n_scene, n_scene + 1, n_scene + 2
    rows = np.concatenate([rows, rows[busy * tb:(busy + 1) * tb],
                           _origin_plane_block(tb, shared_origin),
                           np.zeros((tb, 16), np.float32)])
    tris = torch.from_numpy(rows)
    n_blocks = rows.shape[0] // tb

    # Each ray's nearest hit over every block, without exclusion.
    every = torch.arange(n_blocks, dtype=torch.int32)
    dense = (torch.arange(N_TILES, dtype=torch.int32).repeat_interleave(
        n_blocks), every.repeat(N_TILES))
    near_kw = dict(rt=rt, tb=tb, shared_origin=shared_origin)
    scene_only = dense[1] != plane
    best_t, best_i = bsr_trace.bsr_nearest_ref(
        rays, no_excl, tris, dense[0][scene_only], dense[1][scene_only],
        torch.zeros(int(scene_only.sum())), gid_base=gid_base, **near_kw)
    hit = torch.isfinite(best_t).numpy()

    # Exclusion: a quarter of the rays exclude their own nearest triangle,
    # a tenth a random id; a ray from a surface, its own triangle.
    u = rng.uniform(size=r)
    excl = np.where((u < 0.25) & hit, best_i.numpy(), -1)
    excl = np.where((u >= 0.25) & (u < 0.35),
                    rng.integers(0, rows.shape[0], r) + GID_BASE, excl)
    excl = np.where(own >= 0, own + GID_BASE, excl)
    exclude = torch.from_numpy(excl.astype(np.int32))

    # t_max: at, below and above the nearest hit; unbounded otherwise.
    bt = best_t.numpy()
    u = rng.uniform(size=r)
    tmax = np.where(u < 0.2, bt, np.where(u < 0.6, bt * rng.uniform(
        0.5, 1.5, r), bsr_trace.BIG_TMAX))
    rays[6] = torch.from_numpy(np.where(np.isfinite(tmax), tmax,
                                        bsr_trace.BIG_TMAX).astype(np.float32))

    # Seeds: tile 3 and a fifth of the rays start from a finite nearest
    # (some tie the best hit's t); tile 6 and a tenth start as hit.
    tile = np.arange(r) // rt
    u = rng.uniform(size=r)
    seeded = ((u < 0.2) | (tile == 3)) & hit
    tie = seeded & (u < 0.05)
    init_t = np.where(seeded, np.where(tie, bt, bt * rng.uniform(0.5, 1.5, r)),
                      np.inf).astype(np.float32)
    init_i = np.where(seeded, rng.integers(0, rows.shape[0], r),
                      bsr_trace.BIG_IDX).astype(np.int32)
    init_hit = ((rng.uniform(size=r) < 0.1) | (tile == 6)).astype(np.int32)

    # The work list, tile by tile.
    hits, least = _dense_items(rays, exclude, tris, gid_base, rt, tb,
                               shared_origin)
    hits, least = hits.numpy(), least.numpy()
    scene_blocks = np.arange(n_scene)
    ranked = lambda t: scene_blocks[np.argsort(-hits[t, :n_scene],
                                               kind="stable")]
    heavy = np.resize(np.concatenate([[dup], scene_blocks, [zero]]),
                      max(4 * chunk + 5, n_scene + 2))
    runs = {
        0: ranked(0)[:1],
        2: heavy,
        3: rng.permutation(np.concatenate([scene_blocks, [dup, zero]])),
        4: ranked(4)[:2],
        6: np.concatenate([ranked(6)[:6], [plane]]),
        7: np.concatenate([[dup], scene_blocks, [zero]]),
    }
    t_ids = np.concatenate([np.full(len(b), t) for t, b in runs.items()])
    b_ids = np.concatenate(list(runs.values()))
    count = len(t_ids)
    # Past count: slots that would change tiles 1 and 5 if they ran.
    t_ids = np.concatenate([t_ids, np.repeat([1, 5], _PAST_COUNT // 2)])
    b_ids = np.concatenate([b_ids, np.resize(ranked(1)[:_PAST_COUNT // 2],
                                             _PAST_COUNT)])
    entry = np.where(np.arange(len(t_ids)) < count,
                     least[t_ids, b_ids], 0.0).astype(np.float32)
    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32))
    launch = EdgeCaseLaunch(
        rays=rays, exclude=exclude, tris=tris, tile_ids=i32(t_ids),
        block_ids=i32(b_ids), entry=torch.from_numpy(entry),
        count=i32([count]), init_t=torch.from_numpy(init_t),
        init_i=torch.from_numpy(init_i), init_hit=torch.from_numpy(init_hit),
        gid_base=gid_base, rt=rt, tb=tb, shared_origin=shared_origin)
    if mxu_origins:
        static_rows = static.numpy()
        launch = _tuple_form(launch, np.concatenate(
            [static_rows, static_rows[busy * tb:(busy + 1) * tb]]),
            mxu_origins)
    return launch


def _tuple_form(launch: EdgeCaseLaunch, static: np.ndarray,
                origins: int) -> EdgeCaseLaunch:
    """The shared-origin launch with its (T, 16) rows as the tensor-core
    tuple: A = pack_dirs of the rows (whose directions are the static
    rows'), scal = their (num, a_u, a_v) columns, which fold_origin_scal of
    the static rows for ORIGIN gives bit for bit (the scene and the copied
    block; the origin-plane and zero blocks are built folded). With two
    origins, fold_origin_scal of the static scene and copied rows for
    ORIGIN2 (the origin-plane and zero blocks as zero rows: num = a_u =
    a_v = 0) is stacked after them, every other live item's block id
    carries the n_blocks offset into it, ablock_ids stays the A block, and
    each live item's entry is its least valid t under its own scalars."""
    tb = launch.tb
    rows = launch.tris
    n_blocks = rows.shape[0] // tb
    dirs = torch.from_numpy(bsr_trace.pack_dirs(rows.numpy(), tb))
    pad = rows.new_zeros((rows.shape[0], 5))
    scal = torch.cat([rows[:, [3, 7, 11]], pad], dim=1)
    block_ids = launch.block_ids.clone()
    ablock_ids = launch.block_ids.clone()
    entry = launch.entry.clone()
    if origins == 2:
        static = torch.from_numpy(np.concatenate([
            static, np.zeros((rows.shape[0] - static.shape[0], 16),
                             np.float32)]))
        scal = torch.cat([scal, bsr_trace.fold_origin_scal(
            static, torch.tensor(ORIGIN2, dtype=torch.float32))])
        n = int(launch.count)
        second = torch.arange(1, n, 2)
        block_ids[second] += n_blocks
        for k in range(0, len(second), 32):
            w = second[k:k + 32]
            t, valid, _, _ = bsr_trace._pairs(
                launch.rays, launch.exclude, (dirs, scal),
                launch.tile_ids[w].long(), block_ids[w].long(),
                ablock_ids[w].long(), launch.gid_base.long(), launch.rt, tb,
                True)
            entry[w] = torch.where(valid, t, float("inf")).amin(dim=(1, 2))
    return dataclasses.replace(launch, tris=(dirs, scal), block_ids=block_ids,
                               ablock_ids=ablock_ids, entry=entry)


def ring_edge_case(n: int, rt: int = 128, shared_origin: bool = False):
    """The edge cases as one ring query over n ranks (ops/ring_trace.py):
    (rays (8, R), tris (T, 16), exclude (R,) int32), on the CPU, to be split
    into n equal parts along R and T. tris are the per-ray launch's static
    pack_tris rows (the two spheres, the copied block whose hits tie at one
    t with a second id, the origin-plane block, the all-zero block) padded
    with zero rows to a multiple of n * 128. rays are the launch's of the
    origin form asked for: per-ray (surface origins excluding their own
    triangle) or all from ORIGIN (hits at t = +-0.0 on the origin-plane
    block), t_max in row 6 for the any-hit query. R = N_TILES * rt, so n
    must divide N_TILES. Exclusion ids are the launch's without its
    gid_base: the ring's global id of a row is its index in tris."""
    if N_TILES % n:
        raise ValueError(f"n={n} does not divide {N_TILES} ray tiles")
    static = edge_case_launch(rt, 128, shared_origin=False)
    launch = (edge_case_launch(rt, 128, shared_origin=True)
              if shared_origin else static)
    t = static.tris.shape[0]
    tris = torch.zeros((-(-t // (n * 128)) * n * 128, 16))
    tris[:t] = static.tris
    exclude = torch.where(launch.exclude >= 0, launch.exclude - GID_BASE,
                          -1).to(torch.int32)
    return launch.rays.contiguous(), tris, exclude


def ambiguous_rays(L: EdgeCaseLaunch, rtol: float = 1e-6,
                   origin_ulps: float = 4.0, dot_ulps: float = 0.0):
    """((R,) bool for the nearest query, (R,) bool for the any-hit query):
    the rays of L whose result may differ between two implementations of
    the pair math that round differently, found from the port's own pair
    math over each ray's live items:
      - a pair with a barycentric (u, v or u + v) within rtol of a
        BARY_EPS bound, no farther than the ray's nearest hit (any hit: its
        t_max);
      - two candidates (triangles, or a triangle and the init seed) whose t
        agree to rtol at the ray's nearest hit; any hit: a valid pair whose
        t agrees with t_max to rtol;
      - a grazing hit no farther than that, whose den = n.d cancels so far
        (sum |n_i d_i| > 2^23 * rtol |den|) that t itself is uncertain
        beyond rtol; with per-ray origins also a numerator w - n.o that
        cancels as far.
    With per-ray origins the band is widened by origin_ulps ulps of the
    origin dots' terms (sum |k_i o_i|). dot_ulps > 0 widens it by the error
    of direction dots computed elsewhere (the tensor cores' 3xTF32) to
    dot_ulps ulps of their terms: in t through den, in u and v through
    k_u.d, k_v.d and t. XLA's fused multiply-adds (test_torch_bsr_edges)
    need rtol 1e-6 and no dot_ulps."""
    eps = bsr_trace.BARY_EPS
    shaky_ratio = rtol * 2.0 ** 23
    ulp = 2.0 ** -24
    rt, tb = L.rt, L.tb
    r = L.rays.shape[1]
    n = int(L.count)
    tris = L.rows().reshape(-1, tb, 16)
    o, d = L.rays[0:3].T, L.rays[3:6].T
    near = torch.zeros(r, dtype=torch.bool)
    any_hit = torch.zeros(r, dtype=torch.bool)
    tile_ids = L.tile_ids[:n]
    for tile in torch.unique(tile_ids).tolist():
        blocks = L.block_ids[:n][tile_ids == tile].long()
        tr = tris[blocks].reshape(-1, 16)                     # (P, 16)
        gid = (int(L.gid_base) + blocks[:, None] * tb
               + torch.arange(tb)).reshape(-1)
        sl = slice(tile * rt, (tile + 1) * rt)

        def dot(c0, x):                                       # (rt, P)
            k = tr[None, :, c0:c0 + 3] * x[sl, None, :]
            return k[..., 0] + k[..., 1] + k[..., 2], k.abs().sum(-1)

        den, den_abs = dot(0, d)
        kud, kud_abs = dot(4, d)
        kvd, kvd_abs = dot(8, d)
        num, au, av = tr[None, :, 3], tr[None, :, 7], tr[None, :, 11]
        num_abs, slack = num.abs(), 0.0
        if not L.kwargs["shared_origin"]:                     # per-ray o
            o_n, on_abs = dot(0, o)
            o_u, ou_abs = dot(4, o)
            o_v, ov_abs = dot(8, o)
            num_abs = num_abs + on_abs
            num, au, av = num - o_n, o_u + au, o_v + av
            slack = origin_ulps * ulp * (ou_abs + ov_abs)
        t = num / den
        u = au + t * kud
        v = av + t * kvd
        uv = u + v
        t_rel = rtol
        if dot_ulps:
            t_err = dot_ulps * ulp * den_abs / den.abs()      # relative
            slack = slack + dot_ulps * ulp * t.abs() * (
                kud_abs + kvd_abs) + t_err * t.abs() * (kud.abs()
                                                        + kvd.abs())
            t_rel = rtol + t_err
        valid = ((den != 0) & (t >= 0) & (u >= -eps) & (u <= 1 + eps)
                 & (uv >= -eps) & (uv <= 1 + eps) & (v >= -eps)
                 & (gid[None, :] != L.exclude[sl, None]))
        margin = torch.stack([u + eps, 1 + eps - u, v + eps, uv + eps,
                              1 + eps - uv]).abs().amin(0)
        edge = (margin <= rtol + slack) & (t >= 0)
        shaky = valid & ((den_abs > shaky_ratio * den.abs())
                         | (num_abs > shaky_ratio * num.abs()))
        best = torch.where(valid, t, float("inf")).amin(1)
        seed = L.init_t[sl]
        m = torch.minimum(best, seed)[:, None]
        close = (t - m).abs() <= t_rel * m
        ties = (valid & close).sum(1) + ((seed - best).abs()
                                         <= rtol * best).int() >= 2
        reach = t <= m * (1 + t_rel)
        near[sl] = ties | ((edge | shaky) & reach).any(1)
        tmax = L.rays[6, sl, None]
        at_tmax = valid & ((t - tmax).abs() <= t_rel * tmax)
        any_hit[sl] = (at_tmax | ((edge | shaky)
                                  & (t <= tmax * (1 + t_rel)))).any(1)
    return near, any_hit

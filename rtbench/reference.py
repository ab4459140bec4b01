"""The plain reference: a straightforward tracer of the benchmark's own
triangles, in plain PyTorch, that the program's displayed frames are held
to.

It follows the reference raytracer's semantics (shared/geom/triangle.go:
37-77's Möller-Trumbore with its scalar triple products, tracer.go:15-22's
pixel mapping, tracer.go:53-77's Phong shading with one shadow ray per
light offset 1e-4 along the light, colour.go's saturating adds and
truncating uint8 conversion, camera.go's moves and yaws), in float64. It
imports nothing of the program and takes nothing the program made: it
works out its own acceleration from the triangles, a Morton-sorted
hierarchy of boxes (leaves of LEAF triangles, BRANCH children a node)
whose every test is conservative, so its answers equal a brute-force
test of every triangle.

With `bounces` > 0, `render` adds Whitted reflection bounces as the
program draws them (see its docstring): reflection rays, their nearest
hits shaded as above, and each bounce's colour weighted by the specular
colours of the surfaces before it.

`Arith("tf32")` is the control: the same tracer computed in float32 with
every operand of a product rounded to TF32's 10-bit mantissa, the
precision a matmul takes on the tensor cores with TF32 on. The culling
stays in float64 (conservative either way); every answer is computed in
the lower precision.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple

import numpy as np
import torch

GLOBAL_UP = np.array([0.0, 1.0, 0.0])
SHADOW_OFFSET = 1e-4
# A reflection ray's origin, lifted off its surface as the program lifts
# it (distributed_raytracer_tpu_torch/ops/render_bvh.py:90-104
# `reflect_rows`, with utils/config.py:31 `shadow_offset` 1e-4 along the
# reflected direction and :37 `shadow_normal_offset` 1e-3 along the
# shading normal, on the reflected direction's side).
REFLECT_OFFSET = SHADOW_OFFSET
REFLECT_NORMAL_OFFSET = 1e-3
LEAF = 4
BRANCH = 8
BOX_PAD = 1e-7
CHUNK = 32768        # rays a pass of the candidate search takes
_NO_TRI = torch.iinfo(torch.int64).max


# -- camera (camera.go) -------------------------------------------------------

def _norm(v: np.ndarray) -> np.ndarray:
    return v / math.sqrt(float(v @ v))


@dataclasses.dataclass(frozen=True)
class Pose:
    pos: np.ndarray
    forward: np.ndarray
    left: np.ndarray
    up: np.ndarray
    fov: float

    @staticmethod
    def create(pos, direction, fov: float) -> "Pose":
        direction = np.asarray(direction, np.float64)
        forward = _norm(direction)
        left = _norm(np.cross(direction, GLOBAL_UP))
        return Pose(np.asarray(pos, np.float64), forward, left,
                    np.cross(left, forward), float(fov))

    def strafe(self, distance: float, sign: int) -> "Pose":
        """Move along +left (sign 1) or -left (sign -1); 0 stays."""
        if sign == 0:
            return self
        return dataclasses.replace(
            self, pos=self.pos + _norm(sign * self.left) * distance)

    def yaw(self, theta: float, nudge: float = 1e-4) -> "Pose":
        if math.fmod(theta, 2.0 * math.pi) == 0.0:
            return self
        c, s = math.cos(theta), math.sin(theta)
        a, b = self.forward, self.up
        fwd = _norm(a * c + np.cross(b, a) * s + b * (float(b @ a) * (1 - c)))
        if np.all(np.cross(fwd, GLOBAL_UP) == 0.0):
            fwd = fwd + np.array([nudge, nudge, nudge])
        left = _norm(np.cross(fwd, GLOBAL_UP))
        return dataclasses.replace(self, forward=fwd, left=left,
                                   up=_norm(np.cross(left, fwd)))

    def tick(self, strafe: int, dx: float, width: int,
             move_step: float) -> "Pose":
        """One tick of input (main.go:246-258): a strafe, then the yaw of a
        mouse move of dx pixels (input.go:98-102)."""
        yaw = dx / (width / 2)
        return self.strafe(move_step, strafe).yaw(yaw * self.fov / 2.0)


class State(NamedTuple):
    """The scene at one frame: each instance's offset from its position in
    the SceneSpec, and each light's position (float64)."""
    offsets: np.ndarray     # (O, 3)
    lights: np.ndarray      # (L, 3)


# -- arithmetic ---------------------------------------------------------------

class Arith:
    """float64 ("float64"), or the control: float32 with the operands of
    every product rounded to TF32 ("tf32")."""

    def __init__(self, precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if not self.tf32:
            return x
        bits = x.to(torch.float32).contiguous().view(torch.int32)
        bits = (bits + 0x1000) & ~0x1FFF        # round to 10 mantissa bits
        return bits.view(torch.float32)

    def mul(self, a, b):
        if not self.tf32:
            return a * b
        a = self.q(a) if isinstance(a, torch.Tensor) else a
        b = self.q(b) if isinstance(b, torch.Tensor) else b
        return a * b

    def dot(self, a, b):
        return (self.mul(a[..., 0], b[..., 0]) + self.mul(a[..., 1], b[..., 1])
                + self.mul(a[..., 2], b[..., 2]))

    def cross(self, a, b):
        m = self.mul
        return torch.stack([
            m(a[..., 1], b[..., 2]) - m(a[..., 2], b[..., 1]),
            m(a[..., 2], b[..., 0]) - m(a[..., 0], b[..., 2]),
            m(a[..., 0], b[..., 1]) - m(a[..., 1], b[..., 0])], dim=-1)

    def unit(self, v):
        return v / torch.sqrt(self.dot(v, v))[..., None]


# -- the triangles ------------------------------------------------------------

@dataclasses.dataclass
class Soup:
    p1: torch.Tensor     # (T, 3) float64
    e1: torch.Tensor     # p2 - p1
    e2: torch.Tensor     # p3 - p1
    n: torch.Tensor      # (T, 3, 3) vertex normals
    obj: torch.Tensor    # (T,) int64 instance index
    mat: torch.Tensor    # (T,) int64 material row
    ka: torch.Tensor     # (M, 3)
    kd: torch.Tensor
    ks: torch.Tensor
    ns: torch.Tensor     # (M,)
    light_pos: torch.Tensor
    light_col: torch.Tensor


def soup(scene, device, state: State = None) -> Soup:
    """World-space float64 triangles of a SceneSpec, on `device`; with a
    `state`, each instance moved by its offset and the state's lights."""
    dev = torch.device(device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=dev)
    names = list(scene.meshes)
    parts = {k: [] for k in ("p1", "e1", "e2", "n", "obj", "mat")}
    for i, (name, offset) in enumerate(scene.instances):
        if state is not None:
            offset = np.asarray(offset, np.float64) + state.offsets[i]
        m = scene.meshes[name]
        faces = torch.as_tensor(np.asarray(m.faces, np.int64), device=dev)
        tri = (f64(m.vertices) + f64(offset))[faces]
        parts["p1"].append(tri[:, 0])
        parts["e1"].append(tri[:, 1] - tri[:, 0])
        parts["e2"].append(tri[:, 2] - tri[:, 0])
        parts["n"].append(f64(m.normals)[faces])
        parts["obj"].append(torch.full((len(faces),), i, device=dev))
        parts["mat"].append(torch.full((len(faces),), names.index(name),
                                       device=dev))
    mats = [scene.meshes[k].material for k in names]
    return Soup(**{k: torch.cat(v) for k, v in parts.items()},
                ka=f64([m[0] for m in mats]), kd=f64([m[1] for m in mats]),
                ks=f64([m[2] for m in mats]), ns=f64([m[3] for m in mats]),
                light_pos=f64(scene.light_pos if state is None
                              else state.lights),
                light_col=f64(scene.light_col))


# -- acceleration -------------------------------------------------------------

@dataclasses.dataclass
class Accel:
    soup: Soup
    leaf_tris: torch.Tensor        # (n_leaves, LEAF) int64, -1 = none
    lo: List[torch.Tensor]         # per level, top first: (n, 3) float64
    hi: List[torch.Tensor]


def _morton(points: torch.Tensor) -> torch.Tensor:
    lo = points.amin(0)
    span = torch.clamp_min(points.amax(0) - lo, 1e-12)
    cells = ((points - lo) / span * 1023).to(torch.int64).clamp(0, 1023)
    code = torch.zeros(points.shape[0], dtype=torch.int64,
                       device=points.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((cells[:, axis] >> bit) & 1) << (3 * bit + axis)
    return code


def build(s: Soup) -> Accel:
    """The hierarchy of boxes over the soup's triangles."""
    t = s.p1.shape[0]
    order = torch.argsort(_morton(s.p1 + (s.e1 + s.e2) / 3.0), stable=True)
    n_leaves = -(-t // LEAF)
    leaf_tris = torch.full((n_leaves * LEAF,), -1, dtype=torch.int64,
                           device=s.p1.device)
    leaf_tris[:t] = order
    leaf_tris = leaf_tris.view(n_leaves, LEAF)
    verts = torch.stack([s.p1, s.p1 + s.e1, s.p1 + s.e2], dim=1)
    tri_lo, tri_hi = verts.amin(1), verts.amax(1)
    inf = torch.full((1, 3), math.inf, dtype=torch.float64,
                     device=s.p1.device)
    pad_lo = torch.cat([tri_lo, inf])        # index -1 -> the empty box
    pad_hi = torch.cat([tri_hi, -inf])
    lo = pad_lo[leaf_tris].amin(1) - BOX_PAD
    hi = pad_hi[leaf_tris].amax(1) + BOX_PAD
    los, his = [lo], [hi]
    while los[0].shape[0] > 4 * BRANCH:
        n = los[0].shape[0]
        groups = -(-n // BRANCH)
        fill = groups * BRANCH - n
        lo = torch.cat([los[0], inf.expand(fill, 3)]).view(groups, BRANCH, 3)
        hi = torch.cat([his[0], -inf.expand(fill, 3)]).view(groups, BRANCH, 3)
        los.insert(0, lo.amin(1))
        his.insert(0, hi.amax(1))
    return Accel(soup=s, leaf_tris=leaf_tris, lo=los, hi=his)


def _slab(o, inv, lo, hi, tmax):
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    near = torch.minimum(t1, t2).amax(-1)
    far = torch.maximum(t1, t2).amin(-1)
    return (far >= torch.clamp_min(near, 0.0)) & (near <= tmax)


def _pairs(acc: Accel, o, d, tmax):
    """(ray, triangle) candidate pairs: every triangle whose leaf box the
    ray segment [0, tmax] may meet (float64, conservative)."""
    dev = o.device
    r = o.shape[0]
    inv = 1.0 / torch.where(d == 0.0, 1e-300, d)
    n_top = acc.lo[0].shape[0]
    ray = torch.arange(r, device=dev).repeat_interleave(n_top)
    node = torch.arange(n_top, device=dev).repeat(r)
    for level in range(len(acc.lo)):
        if level:
            n = acc.lo[level].shape[0]
            node = (node[:, None] * BRANCH
                    + torch.arange(BRANCH, device=dev)).reshape(-1)
            ray = ray.repeat_interleave(BRANCH)
            ok = node < n
            ray, node = ray[ok], node[ok]
        keep = _slab(o[ray], inv[ray], acc.lo[level][node],
                     acc.hi[level][node], tmax[ray])
        ray, node = ray[keep], node[keep]
    tri = acc.leaf_tris[node].reshape(-1)
    ray = ray.repeat_interleave(acc.leaf_tris.shape[1])
    ok = tri >= 0
    return ray[ok], tri[ok]


def _intersect(ar: Arith, s: Soup, o, d, tri):
    """Möller-Trumbore of rays (P, 3) against triangles tri (P,) as
    triangle.go:37-77 computes it: (valid, t, r1, r2, r3)."""
    cast = lambda x: x.to(ar.dtype)
    p1, e1, e2 = cast(s.p1[tri]), cast(s.e1[tri]), cast(s.e2[tri])
    neg_d = -d
    c1 = ar.cross(e2, neg_d)
    inc = ar.dot(e1, c1)
    sv = o - p1
    r2 = ar.dot(sv, c1) / inc
    r3 = ar.dot(e1, ar.cross(sv, neg_d)) / inc
    r1 = 1.0 - r2 - r3
    t = ar.dot(e1, ar.cross(e2, sv)) / inc
    valid = ((inc != 0.0) & (r2 >= 0.0) & (r2 <= 1.0) & (r2 + r3 >= 0.0)
             & (r2 + r3 <= 1.0) & (r1 >= 0.0) & (r3 >= 0.0) & (t >= 0.0))
    return valid, t, r1, r2, r3


def nearest(ar: Arith, acc: Accel, o, d, chunk: int = None,
            exclude=None):
    """Nearest hit of each ray: (t (inf on a miss), triangle (-1), r1, r2,
    r3); ties go to the lower triangle index. `exclude` (R,) int64, where
    given, is a triangle each ray does not see (the one it leaves)."""
    r = o.shape[0]
    dev = o.device
    chunk = chunk or CHUNK
    t_best = torch.full((r,), math.inf, dtype=ar.dtype, device=dev)
    tri_best = torch.full((r,), _NO_TRI, dtype=torch.int64, device=dev)
    o64 = o.to(torch.float64)
    d64 = d.to(torch.float64)
    far = torch.full((r,), math.inf, dtype=torch.float64, device=dev)
    for a in range(0, r, chunk):
        b = min(r, a + chunk)
        ray, tri = _pairs(acc, o64[a:b], d64[a:b], far[a:b])
        ray = ray + a
        valid, t, _, _, _ = _intersect(ar, acc.soup, o[ray], d[ray], tri)
        if exclude is not None:
            valid &= tri != exclude[ray]
        ray, tri, t = ray[valid], tri[valid], t[valid]
        t_best.scatter_reduce_(0, ray, t, "amin")
        best = t == t_best[ray]
        tri_best.scatter_reduce_(0, ray[best], tri[best], "amin")
    hit = tri_best != _NO_TRI
    tri = torch.where(hit, tri_best, 0)
    _, t, r1, r2, r3 = _intersect(ar, acc.soup, o, d, tri)
    return (torch.where(hit, t, math.inf), torch.where(hit, tri_best, -1),
            r1, r2, r3)


def occluded(ar: Arith, acc: Accel, o, d, tmax, chunk: int = None):
    """Whether each ray meets a triangle at 0 <= t <= tmax."""
    r = o.shape[0]
    chunk = chunk or CHUNK
    out = torch.zeros(r, dtype=torch.bool, device=o.device)
    o64, d64 = o.to(torch.float64), d.to(torch.float64)
    tmax64 = tmax.to(torch.float64)
    for a in range(0, r, chunk):
        b = min(r, a + chunk)
        ray, tri = _pairs(acc, o64[a:b], d64[a:b], tmax64[a:b])
        ray = ray + a
        valid, t, _, _, _ = _intersect(ar, acc.soup, o[ray], d[ray], tri)
        out[ray[valid & (t <= tmax[ray])]] = True
    return out


# -- frames -------------------------------------------------------------------

def _hits(ar: Arith, acc: Accel, o, d, viewer, exclude=None):
    """Each ray's nearest hit, shaded (tracer.go:53-77): (the rays that hit
    (K,), their hit points (K, 3), shading normals (K, 3) and triangles
    (K,), their colour (K, 3) before the clamp, and their decision code
    (K,): the object hit and which lights light it). `viewer` is the point
    the specular term looks from: (3,) for every ray, or (R, 3), one a
    ray."""
    s = acc.soup
    t, tri, r1, r2, r3 = nearest(ar, acc, o, d, exclude=exclude)
    hit = tri >= 0
    idx = torch.nonzero(hit).squeeze(1)
    ti = tri[idx]
    x = o[idx] + ar.mul(t[idx, None], d[idx])
    nv = s.n[ti].to(ar.dtype)
    n = ar.unit(ar.mul(r1[idx, None], nv[:, 0]) + ar.mul(r2[idx, None],
                                                         nv[:, 1])
                + ar.mul(r3[idx, None], nv[:, 2]))
    mat = s.mat[ti]
    ka, kd, ks = (s.ka[mat].to(ar.dtype), s.kd[mat].to(ar.dtype),
                  s.ks[mat].to(ar.dtype))
    ns = s.ns[mat].to(ar.dtype)
    view = ar.unit((viewer if viewer.dim() == 1 else viewer[idx]) - x)
    colour = ka
    code = s.obj[ti] + 1
    for li in range(s.light_pos.shape[0]):
        to_light = s.light_pos[li].to(ar.dtype)[None, :] - x
        ldist = torch.sqrt(ar.dot(to_light, to_light))
        ldir = to_light / ldist[:, None]
        ldn = ar.dot(ldir, n)
        refl = ar.mul(ar.mul(2.0, ldn)[:, None], n) - ldir
        spec = torch.pow(torch.clamp_min(ar.dot(refl, view), 0.0), ns)
        contrib = ar.mul(ar.mul(kd, torch.clamp_min(ldn, 0.0)[:, None])
                         + ar.mul(ks, spec[:, None]),
                         s.light_col[li].to(ar.dtype)[None, :])
        matters = contrib.amax(1) > 0.0
        lit = matters.clone()
        q = torch.nonzero(matters).squeeze(1)
        origin = x[q] + ar.mul(SHADOW_OFFSET, ldir[q])
        lit[q] = ~occluded(ar, acc, origin, ldir[q],
                           ldist[q] - SHADOW_OFFSET)
        colour = colour + torch.where(lit[:, None], contrib, 0.0)
        code = code * 2 + lit.to(torch.int64)
    return idx, x, n, ti, colour, code


def render(acc: Accel, pose: Pose, width: int, height: int, ys, xs,
           ar: Arith = Arith(), bounces: int = 0):
    """The pixels (ys, xs) of the frame at `pose`: (rgb uint8 (N, 3),
    decision code (N,) int64: which object was hit (0 = none) and which
    lights light it, where their light could change the pixel).

    With `bounces` = D > 0, Whitted reflections as the program draws them
    (distributed_raytracer_tpu_torch/ops/render_bvh.py:751-758 and
    `render_bounced`, `_bounce` :772-783, `reflect_rows` :90-104; the
    float64 oracle's `_radiance`, utils/oracle.py:136-163):
      - the colour is the sum over bounces b = 0..D of throughput_b times
        bounce b's Phong colour (itself clamped, as the program's shading
        clamps its saturating adds), clamped once at the end;
      - bounce b's specular term looks from bounce b-1's hit point (the
        camera at b = 0);
      - throughput_0 = 1, throughput_{b+1} = throughput_b * Ks of the
        surface bounce b hit;
      - a miss, or a Ks of zero, ends the path and adds nothing;
      - the reflected direction is d - 2 (d.n) n about the shading normal
        n, normalised;
      - its origin is the hit point lifted as the program lifts it:
        REFLECT_OFFSET (1e-4, the program's `shadow_offset`) along the
        reflected direction and REFLECT_NORMAL_OFFSET (1e-3, its
        `shadow_normal_offset`) along n on the reflected direction's side;
        and, as in the program (the hit triangle is the next query's
        exclude id, render_bvh.py:783), the ray does not see the triangle
        it leaves. The oracle departs here: it lifts the origin 1e-4 along
        the reflected direction alone and excludes nothing.
    Shadows at every bounce are this module's own (one ray per light,
    offset 1e-4 along the light). The decision code is then a dense id of
    every bounce's code (the object hit and the lights that light it, 0
    where the path has ended), so `continuity` sets reflected edges and
    reflected shadow boundaries aside as it does primary ones."""
    if bounces < 0:
        raise ValueError(f"bounces={bounces}: must be >= 0")
    s = acc.soup
    dev = s.p1.device
    vec = lambda a: torch.as_tensor(np.asarray(a), dtype=ar.dtype,
                                    device=dev)
    half_w, half_h = width // 2, height // 2
    phw = math.tan(pose.fov / 2.0)
    phh = phw * height / width
    i = xs.to(ar.dtype)
    j = ys.to(ar.dtype)
    a = ar.mul(phw, (half_w - i) - 0.5) / half_w
    b = ar.mul(phh, (half_h - j) - 0.5) / half_h
    d = ar.unit(vec(pose.forward)[None, :] + ar.mul(a[:, None],
                                                    vec(pose.left)[None, :])
                + ar.mul(b[:, None], vec(pose.up)[None, :]))
    cam = vec(pose.pos)
    o = cam.expand_as(d)
    idx, x, n, ti, colour, code = _hits(ar, acc, o, d, cam)
    rgb = torch.zeros((d.shape[0], 3), dtype=ar.dtype, device=dev)
    rgb[idx] = torch.clamp(colour, 0.0, 1.0)
    full_code = torch.zeros(d.shape[0], dtype=torch.int64, device=dev)
    full_code[idx] = code
    if bounces:
        rgb, full_code = _reflections(ar, acc, bounces, rgb, full_code,
                                      idx, d[idx], x, n, ti)
    return (ar.mul(255.0, rgb)).to(torch.uint8), full_code


def _reflections(ar: Arith, acc: Accel, bounces: int, colour, code, live,
                 d, x, n, tri):
    """Bounces 1..`bounces` (render's docstring) added to bounce 0's
    clamped colour (N, 3) and code (N,), from the rays `live` that hit,
    with their directions, hit points, shading normals and triangles.
    Returns (rgb (N, 3) clamped once, decision code (N,))."""
    s = acc.soup
    throughput = torch.ones_like(colour)
    codes = [code]
    for _ in range(bounces):
        ks = s.ks[s.mat[tri]].to(ar.dtype)
        throughput[live] = ar.mul(throughput[live], ks)
        keep = (ks > 0.0).any(1)
        live, d, x, n, tri = live[keep], d[keep], x[keep], n[keep], tri[keep]
        refl = ar.unit(d - ar.mul(ar.mul(2.0, ar.dot(d, n))[:, None], n))
        side = torch.where(ar.dot(n, refl) >= 0.0, 1.0, -1.0)
        o = (x + ar.mul(REFLECT_OFFSET, refl)
             + ar.mul(ar.mul(REFLECT_NORMAL_OFFSET, side)[:, None], n))
        idx, x, n_hit, tri, local, c = _hits(ar, acc, o, refl, x,
                                             exclude=tri)
        rows = live[idx]
        colour[rows] = colour[rows] + ar.mul(throughput[rows],
                                             torch.clamp(local, 0.0, 1.0))
        bounce_code = torch.zeros_like(code)
        bounce_code[rows] = c
        codes.append(bounce_code)
        live, d, n = rows, refl[idx], n_hit
    _, dense = torch.unique(torch.stack(codes, 1), dim=0,
                            return_inverse=True)
    return torch.clamp(colour, 0.0, 1.0), dense

def continuity(code: torch.Tensor) -> torch.Tensor:
    """(H, W) bool: pixels whose 3x3 neighbourhood (the image's edge
    repeated) shares their decision code: where float32 and float64 cannot
    pick another object or shadow outcome across the pixel."""
    h, w = code.shape
    p = torch.nn.functional.pad(code[None, None].to(torch.float64),
                                (1, 1, 1, 1), mode="replicate")[0, 0]
    same = torch.ones((h, w), dtype=torch.bool, device=code.device)
    for dy in range(3):
        for dx in range(3):
            same &= p[dy:dy + h, dx:dx + w] == code.to(torch.float64)
    return same

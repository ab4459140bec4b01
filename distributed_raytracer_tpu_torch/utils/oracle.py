"""Golden-image oracle: a float64 NumPy tracer following the reference math.

A copy of distributed_raytracer_tpu/utils/oracle.py with the port's camera,
scene and tile modules in place of the JAX package's (which would import
jax), so frames rendered on a machine without JAX can be held to it; the
logic is unchanged (tests/test_torch_oracle.py holds it bit-equal to the
original). `discontinuity_mask` and `assert_images_close` are copied from
the JAX package's golden tests (tests/test_render_golden.py), the one
tolerance images are held to against the oracle.

The reference repo has no automated tests (SURVEY.md §4); its correctness
oracle was the sequential renderer (worker/sequential/main.go), which shares
tracer.Trace with the distributed workers. This module is the executable
equivalent: an *independent* implementation (scalar-triple-product
Möller–Trumbore exactly as in shared/geom/triangle.go:37-77, sequential
saturating colour adds as in shared/colour/colour.go:38-50, per-light shadow
rays as in tracer.go:53-77) in float64, vectorized only over triangles.
Kernels are validated against these images within per-channel tolerance.

Deliberate divergences from the Go code (shared with the renderers):
  - nearest-hit selection across *objects* uses ray-origin distance, not
    camera distance (tracer.go:38 measures from env.Cam.Pos; identical for
    primary rays, which originate at the camera)
  - flat-shaded meshes get their face normal baked into the vertex-normal
    slots (interpolation then reproduces triangle.go:24-26 exactly)
"""

from __future__ import annotations

import numpy as np

from distributed_raytracer_tpu_torch.models.camera import Camera
from distributed_raytracer_tpu_torch.models.scene import Scene


class _Soup:
    """Float64 world-space triangle soup with reference-layout fields."""

    def __init__(self, scene: Scene):
        p1s, e1s, e2s, n0s, n1s, n2s, mats = [], [], [], [], [], [], []
        materials = []
        for obj in scene.objects:
            mesh = scene.meshes[obj.model]
            base = len(materials)
            materials.extend(mesh.materials)
            v = mesh.vertices + obj.pos[None, :]
            tri = v[mesh.faces_v]
            p1s.append(tri[:, 0])
            e1s.append(tri[:, 1] - tri[:, 0])  # p1p2 (triangle.go:38)
            e2s.append(tri[:, 2] - tri[:, 0])  # p1p3
            if mesh.has_normals:
                n = mesh.normals[mesh.faces_n]
                n0s.append(n[:, 0]); n1s.append(n[:, 1]); n2s.append(n[:, 2])
            else:
                fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
                fn /= np.linalg.norm(fn, axis=1, keepdims=True)
                n0s.append(fn); n1s.append(fn); n2s.append(fn)
            mats.append(mesh.face_mat + base)
        self.p1 = np.concatenate(p1s)
        self.e1 = np.concatenate(e1s)
        self.e2 = np.concatenate(e2s)
        self.n0 = np.concatenate(n0s)
        self.n1 = np.concatenate(n1s)
        self.n2 = np.concatenate(n2s)
        self.mat = np.concatenate(mats)
        self.ka = np.array([m.ka for m in materials])
        self.kd = np.array([m.kd for m in materials])
        self.ks = np.array([m.ks for m in materials])
        self.ns = np.array([m.ns for m in materials])


def _trace(soup: _Soup, o: np.ndarray, d: np.ndarray):
    """Nearest hit of one ray vs all triangles, following triangle.go:37-77.

    Returns (t, tri_index, r1, r2, r3) with t = +inf when there is no hit
    (d is unit length, so t equals the distance from the ray origin).
    """
    neg_d = -d
    c1 = np.cross(soup.e2, neg_d[None, :])
    inc = np.einsum("td,td->t", soup.e1, c1)
    s = o[None, :] - soup.p1
    with np.errstate(divide="ignore", invalid="ignore"):
        r2 = np.einsum("td,td->t", s, c1) / inc
        c2 = np.cross(s, neg_d[None, :])
        r3 = np.einsum("td,td->t", soup.e1, c2) / inc
        r1 = 1.0 - r2 - r3
        t = np.einsum("td,td->t", soup.e1, np.cross(soup.e2, s)) / inc
        valid = (
            (inc != 0.0)
            & (r2 >= 0.0) & (r2 <= 1.0)
            & (r2 + r3 >= 0.0) & (r2 + r3 <= 1.0)
            & (r1 >= 0.0) & (r3 >= 0.0)
            & (t >= 0.0)
        )
    cand = np.where(valid, t, np.inf)
    idx = int(np.argmin(cand))
    return cand[idx], idx, r1[idx], r2[idx], r3[idx]


def _sat_add(a, b):
    return np.minimum(a + b, 1.0)


def _sat_scale(a, s):
    return np.clip(s * a, 0.0, 1.0)


def _phong(soup: _Soup, x, normal, mat, cam_pos, lights_pos, lights_col,
           shadow_offset=1e-4):
    """tracer.go:53-77, sequential per-light saturating accumulation.

    Returns (colour, per-light lit flags)."""
    colour = soup.ka[mat].copy()
    lits = []
    for lpos, lcol in zip(lights_pos, lights_col):
        to_light = lpos - x
        ldist = np.linalg.norm(to_light)
        ldir = to_light / ldist
        t, _, _, _, _ = _trace(soup, x + shadow_offset * ldir, ldir)
        if np.isfinite(t):
            hit_dist = np.linalg.norm((x + shadow_offset * ldir + t * ldir) - x)
            lit = ldist < hit_dist  # hits beyond the light don't shadow
        else:
            lit = True
        lits.append(lit)
        if lit:
            l_dot_n = float(ldir @ normal)
            refl = 2.0 * l_dot_n * normal - ldir
            cam_dir = (cam_pos - x) / np.linalg.norm(cam_pos - x)
            colour = _sat_add(colour, _sat_scale(soup.kd[mat], max(l_dot_n, 0.0)) * lcol)
            colour = _sat_add(colour, _sat_scale(
                soup.ks[mat], max(float(refl @ cam_dir), 0.0) ** soup.ns[mat]) * lcol)
    return colour, np.asarray(lits, dtype=bool)


def _radiance(soup: _Soup, o: np.ndarray, d: np.ndarray, cam_pos, lights_pos,
              lights_col, depth: int, shadow_offset=1e-4):
    """Whitted radiance for the multi-bounce extension, matching
    ops/render.py trace_rays_bounced exactly: colour = sum over bounces of
    (prod of earlier Ks) * phong_b, clamped once at the end. The specular
    viewer at each bounce is the previous hit point."""
    colour = np.zeros(3)
    throughput = np.ones(3)
    view = cam_pos
    for _ in range(depth + 1):
        t, idx, r1, r2, r3 = _trace(soup, o, d)
        if not np.isfinite(t):
            break
        x = o + t * d
        n = r1 * soup.n0[idx] + r2 * soup.n1[idx] + r3 * soup.n2[idx]
        n = n / np.linalg.norm(n)
        local, _ = _phong(soup, x, n, soup.mat[idx], view, lights_pos,
                          lights_col, shadow_offset)
        colour = colour + throughput * local
        throughput = throughput * soup.ks[soup.mat[idx]]
        if not np.any(throughput > 0.0):
            break
        refl = d - 2.0 * float(d @ n) * n
        refl = refl / np.linalg.norm(refl)
        view = x
        o = x + shadow_offset * refl
        d = refl
    return np.clip(colour, 0.0, 1.0), True


def render_oracle_bounced(scene: Scene, width: int, height: int, depth: int,
                          camera: Camera | None = None) -> np.ndarray:
    """Golden image for the multi-bounce extension."""
    cam = camera if camera is not None else scene.camera
    soup = _Soup(scene)
    img = np.zeros((height, width, 3))
    half_w, half_h = width // 2, height // 2
    phw = np.tan(cam.fov / 2.0)
    phh = phw * height / width
    for j in range(height):
        for i in range(width):
            i_off = cam.left * (phw * ((half_w - i) - 0.5) / half_w)
            j_off = cam.up * (phh * ((half_h - j) - 0.5) / half_h)
            d = cam.forward + i_off + j_off
            d = d / np.linalg.norm(d)
            img[j, i], _ = _radiance(soup, cam.pos, d, cam.pos,
                                     scene.light_pos, scene.light_col, depth)
    return img


def render_oracle(scene: Scene, width: int, height: int,
                  camera: Camera | None = None, return_aux: bool = False):
    """Render (height, width, 3) float64 golden image, black background.

    With return_aux=True also returns a dict of per-pixel decision data
    (hit triangle id, per-light lit mask) used by golden tests to identify
    discontinuity pixels, where float32 and float64 may legitimately pick
    different surfaces or shadow outcomes.
    """
    cam = camera if camera is not None else scene.camera
    soup = _Soup(scene)
    img = np.zeros((height, width, 3))
    n_lights = len(scene.light_pos)
    aux_tri = np.full((height, width), -1, dtype=np.int64)
    aux_lit = np.zeros((height, width, n_lights), dtype=bool)

    half_w, half_h = width // 2, height // 2
    phw = np.tan(cam.fov / 2.0)
    phh = phw * height / width

    for j in range(height):
        for i in range(width):
            # tracer.go:15-22 pixelToPoint
            i_off = cam.left * (phw * ((half_w - i) - 0.5) / half_w)
            j_off = cam.up * (phh * ((half_h - j) - 0.5) / half_h)
            d = cam.forward + i_off + j_off
            d = d / np.linalg.norm(d)
            t, idx, r1, r2, r3 = _trace(soup, cam.pos, d)
            if np.isfinite(t):
                x = cam.pos + t * d
                n = r1 * soup.n0[idx] + r2 * soup.n1[idx] + r3 * soup.n2[idx]
                n = n / np.linalg.norm(n)
                img[j, i], lit = _phong(soup, x, n, soup.mat[idx], cam.pos,
                                        scene.light_pos, scene.light_col)
                aux_tri[j, i] = idx
                aux_lit[j, i] = lit
    if return_aux:
        return img, {"tri": aux_tri, "lit": aux_lit}
    return img


def render_oracle_tiles(scene: Scene, width: int, height: int,
                        workers: int, camera: Camera | None = None,
                        only: "list | None" = None, **bisect_kw):
    """Oracle rendering in the master's own WorkOrder rectangles.

    Partitions the frame with parallel/tile.partition_bisect (the faithful
    master/main.go:54-91 bisection) and renders tile by tile — the
    sequential oracle playing the reference's *distributed* schedule. Two
    uses: golden tests can render ONLY the tiles covering a feature
    (`only` = tile indices) at a fraction of the full-frame oracle cost,
    and the tile decomposition itself is exercised against the oracle
    (every pixel covered exactly once — tested in tests/test_tile.py).

    Returns (img, tiles); pixels outside `only` stay black.
    """
    from distributed_raytracer_tpu_torch.parallel.tile import partition_bisect

    cam = camera if camera is not None else scene.camera
    tiles, _ = partition_bisect(width, height, workers, **bisect_kw)
    soup = _Soup(scene)
    img = np.zeros((height, width, 3))
    half_w, half_h = width // 2, height // 2
    phw = np.tan(cam.fov / 2.0)
    phh = phw * height / width
    for k, tile in enumerate(tiles):
        if only is not None and k not in only:
            continue
        for j in range(tile.y, tile.y + tile.height):
            for i in range(tile.x, tile.x + tile.width):
                i_off = cam.left * (phw * ((half_w - i) - 0.5) / half_w)
                j_off = cam.up * (phh * ((half_h - j) - 0.5) / half_h)
                d = cam.forward + i_off + j_off
                d = d / np.linalg.norm(d)
                t, idx, r1, r2, r3 = _trace(soup, cam.pos, d)
                if np.isfinite(t):
                    x = cam.pos + t * d
                    n = (r1 * soup.n0[idx] + r2 * soup.n1[idx]
                         + r3 * soup.n2[idx])
                    n = n / np.linalg.norm(n)
                    img[j, i], _ = _phong(soup, x, n, soup.mat[idx],
                                          cam.pos, scene.light_pos,
                                          scene.light_col)
    return img, tiles


def to_u8(img: np.ndarray) -> np.ndarray:
    """uint8(255*c) truncation (colour.go:59-61)."""
    return (255.0 * np.clip(img, 0.0, 1.0)).astype(np.uint8)


def discontinuity_mask(aux) -> np.ndarray:
    """True where any decision (hit tri, lit flags) changes in the 3x3
    neighborhood — pixels where fp precision may flip the outcome."""
    tri = aux["tri"]
    lit = aux["lit"]
    h, w = tri.shape
    code = tri.astype(np.int64) + 1  # -1 (miss) -> 0
    for k in range(lit.shape[-1]):
        code = code * 2 + lit[..., k]
    mask = np.zeros((h, w), dtype=bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            shifted = np.roll(np.roll(code, dy, axis=0), dx, axis=1)
            mask |= shifted != code
    return mask


def assert_images_close(got, want, aux, channel_tol=3.0 / 255.0,
                        smooth_outlier_frac=0.002, mean_tol=0.01):
    """float32 frame `got` against the oracle's `want`: continuity pixels
    (off discontinuity_mask(aux)) within channel_tol on all but
    smooth_outlier_frac of them, and the whole image within mean_tol in
    the mean; raises AssertionError otherwise."""
    got = np.asarray(got, dtype=np.float64)
    diff = np.abs(got - want).max(axis=-1)  # per-pixel max channel diff
    smooth = ~discontinuity_mask(aux)
    assert smooth.sum() > 0.2 * smooth.size, "mask degenerated; resolution too low"
    frac_bad = float((diff[smooth] > channel_tol).mean())
    assert frac_bad <= smooth_outlier_frac, (
        f"{frac_bad:.4%} of continuity pixels exceed tolerance "
        f"(max diff there {diff[smooth].max():.4f})")
    assert float(np.abs(got - want).mean()) <= mean_tol

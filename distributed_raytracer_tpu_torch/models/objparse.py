"""Wavefront OBJ/MTL parsing.

A from-scratch parser with the semantics the reference gets from its gwob fork
plus shared/state/mesh.go:109-213:
  - polygons are fan-triangulated (quad -> 2 tris, etc.)
  - vertices and vertex normals are deduplicated by exact value
    (mesh.go:146-148's hash maps)
  - vertex normals are normalized on load (mesh.go:199 `.Norm()`)
  - each `usemtl` group resolves its material from the MTL library, falling
    back to the default material Ka=0x10 grey / Kd=white / Ks=black / Ns=0
    (mesh.go:151)
  - MTL colours are clamped to [0,1] (colour.go:33-35 NewRGBFromFloats)
  - the MTL path is resolved relative to the OBJ file first, then as given
    (mesh.go:118-127)

Returns float64 SoA arrays; downstream device code converts to float32.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# Default material (mesh.go:151): Ka = 0x10 grey, Kd = white, Ks = black, Ns = 0.
DEFAULT_KA = (0x10 / 255.0,) * 3
DEFAULT_KD = (1.0, 1.0, 1.0)
DEFAULT_KS = (0.0, 0.0, 0.0)
DEFAULT_NS = 0.0


@dataclasses.dataclass(frozen=True)
class Material:
    ka: Tuple[float, float, float] = DEFAULT_KA
    kd: Tuple[float, float, float] = DEFAULT_KD
    ks: Tuple[float, float, float] = DEFAULT_KS
    ns: float = DEFAULT_NS


@dataclasses.dataclass
class MeshData:
    """SoA triangle mesh: the array-program replacement for state.Mesh."""

    vertices: np.ndarray        # (V, 3) float64, deduplicated
    normals: np.ndarray         # (Vn, 3) float64 unit vectors; may be empty
    faces_v: np.ndarray         # (F, 3) int32 vertex indices
    faces_n: np.ndarray         # (F, 3) int32 normal indices (all -1 if none)
    face_mat: np.ndarray        # (F,) int32 material indices
    materials: List[Material]

    @property
    def has_normals(self) -> bool:
        return self.normals.size > 0


def _clamp01(x: float) -> float:
    return max(0.0, min(x, 1.0))


def parse_mtl(path: str) -> Dict[str, Material]:
    """Parse an MTL library: newmtl / Ka / Kd / Ks / Ns records."""
    lib: Dict[str, Material] = {}
    name: Optional[str] = None
    ka, kd, ks, ns = DEFAULT_KA, DEFAULT_KD, DEFAULT_KS, DEFAULT_NS

    def flush():
        if name is not None:
            lib[name] = Material(ka=ka, kd=kd, ks=ks, ns=ns)

    with open(path, "r") as f:
        for raw in f:
            parts = raw.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                flush()
                name = parts[1] if len(parts) > 1 else ""
                ka, kd, ks, ns = DEFAULT_KA, DEFAULT_KD, DEFAULT_KS, DEFAULT_NS
            elif key == "Ka":
                ka = tuple(_clamp01(float(v)) for v in parts[1:4])
            elif key == "Kd":
                kd = tuple(_clamp01(float(v)) for v in parts[1:4])
            elif key == "Ks":
                ks = tuple(_clamp01(float(v)) for v in parts[1:4])
            elif key == "Ns":
                ns = float(parts[1])
    flush()
    return lib


def _resolve_index(token: str, count: int) -> int:
    """OBJ indices are 1-based; negative indices are relative to the end."""
    i = int(token)
    return i - 1 if i > 0 else count + i


def _dedup(arr: np.ndarray, index_arrays: List[np.ndarray]) -> Tuple[np.ndarray, List[np.ndarray]]:
    """Deduplicate rows by exact value, preserving first-occurrence order, and
    remap index arrays (the array analog of mesh.go:146-148's hash maps)."""
    if arr.size == 0:
        return arr, index_arrays
    _, first_idx, inverse = np.unique(arr, axis=0, return_index=True, return_inverse=True)
    # np.unique sorts; restore first-seen order.
    order = np.argsort(first_idx)
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    deduped = arr[np.sort(first_idx)]
    remap = rank[inverse]
    return deduped, [remap[ix] for ix in index_arrays]


def parse_obj(path: str, mtl_search: bool = True, backend: str = "auto") -> MeshData:
    """Parse an OBJ file into SoA arrays (semantics of mesh.go:109-213).

    backend: "auto" uses the C++ parser (models/native.py) when available,
    falling back to this Python implementation; "python"/"native" force one.
    """
    if backend in ("auto", "native") and mtl_search:
        from distributed_raytracer_tpu_torch.models import native

        if native.available():
            return native.parse_obj(path)
        if backend == "native":
            raise RuntimeError("native parser requested but unavailable")
    verts: List[Tuple[float, float, float]] = []
    norms: List[Tuple[float, float, float]] = []
    faces_v: List[Tuple[int, int, int]] = []
    faces_n: List[Tuple[int, int, int]] = []
    face_mat: List[int] = []
    mtllib: Optional[str] = None

    materials: List[Material] = []
    mat_index_of: Dict[Material, int] = {}
    current_usemtl: Optional[str] = None
    # face -> usemtl name; resolved to materials after the MTL lib is read.
    face_usemtl: List[Optional[str]] = []

    with open(path, "r") as f:
        for raw in f:
            parts = raw.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v":
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "vn":
                norms.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif key == "mtllib":
                mtllib = raw.split(None, 1)[1].strip()
            elif key == "usemtl":
                current_usemtl = parts[1] if len(parts) > 1 else ""
            elif key == "f":
                corner_v: List[int] = []
                corner_n: List[int] = []
                for token in parts[1:]:
                    comps = token.split("/")
                    corner_v.append(_resolve_index(comps[0], len(verts)))
                    if len(comps) >= 3 and comps[2]:
                        corner_n.append(_resolve_index(comps[2], len(norms)))
                    else:
                        corner_n.append(-1)
                # Fan triangulation (the reference's gwob triangulates quads;
                # generalized to any polygon).
                for k in range(1, len(corner_v) - 1):
                    faces_v.append((corner_v[0], corner_v[k], corner_v[k + 1]))
                    faces_n.append((corner_n[0], corner_n[k], corner_n[k + 1]))
                    face_usemtl.append(current_usemtl)

    # Resolve materials per face.
    mtl_lib: Dict[str, Material] = {}
    if mtllib and mtl_search:
        rel = os.path.join(os.path.dirname(path), mtllib)
        for candidate in (rel, mtllib):
            if os.path.exists(candidate):
                mtl_lib = parse_mtl(candidate)
                break

    for usemtl in face_usemtl:
        mat = mtl_lib.get(usemtl, Material()) if usemtl is not None else Material()
        idx = mat_index_of.get(mat)
        if idx is None:
            idx = len(materials)
            materials.append(mat)
            mat_index_of[mat] = idx
        face_mat.append(idx)
    if not materials:
        materials.append(Material())

    vertices = np.asarray(verts, dtype=np.float64).reshape(-1, 3)
    normals = np.asarray(norms, dtype=np.float64).reshape(-1, 3)
    fv = np.asarray(faces_v, dtype=np.int32).reshape(-1, 3)
    fn = np.asarray(faces_n, dtype=np.int32).reshape(-1, 3)

    vertices, (fv,) = _dedup(vertices, [fv])
    has_normals = normals.size > 0 and np.all(fn >= 0)
    if has_normals:
        lengths = np.linalg.norm(normals, axis=1, keepdims=True)
        normals = normals / lengths  # mesh.go:199 normalizes on load
        normals, (fn,) = _dedup(normals, [fn])
    else:
        normals = np.zeros((0, 3), dtype=np.float64)
        fn = np.full_like(fv, -1)

    return MeshData(
        vertices=vertices,
        normals=normals,
        faces_v=fv,
        faces_n=fn,
        face_mat=np.asarray(face_mat, dtype=np.int32),
        materials=materials,
    )

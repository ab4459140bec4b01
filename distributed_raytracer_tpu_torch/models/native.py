"""ctypes bindings for the C++ runtime components (native/drt_native.cpp).

The JAX package's models/native.py, but for the build: both packages load
(or `make`) the same native/libdrt_native.so at the root of the repository.
This one builds under a lock file into a temporary name and renames it into
place, so processes loading it at once (test workers) never see a
half-written library made here.

The native library provides the host-side hot paths — OBJ/MTL parsing and
Morton argsort — with the Python implementations (objparse.py, bvh.py) as
behavioral reference and fallback. The .so is built on demand from the
checked-in source with the system toolchain; absence of a compiler just
means the Python path is used.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
# The build's lock file and temporary names (listed in .gitignore).
_LOCK_NAME = ".libdrt_native.lock"
_TMP_PREFIX = ".libdrt_native.tmp."

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build(native_dir: str, lib_path: str) -> bool:
    """Builds the library into a temporary name under an exclusive lock
    file in native_dir, then renames it into place: a process that loads
    the library never finds it half written by this one, and two processes
    of this package never build it at once (the second finds it built)."""
    src = os.path.join(native_dir, "drt_native.cpp")
    if not os.path.exists(src):
        return False
    try:
        with open(os.path.join(native_dir, _LOCK_NAME), "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(lib_path):
                return True
            tmp = f"{_TMP_PREFIX}{os.getpid()}.so"
            # TARGET on the command line overrides the Makefile's. A CXX
            # set in the environment can be a compiler that fails the
            # build (one without OpenMP's libgomp.spec, say): then the
            # PATH's g++ gets a second try.
            make = ["make", "-C", native_dir, f"TARGET={tmp}"]
            tries = [make] + ([make + ["CXX=g++"]] if os.environ.get("CXX")
                              else [])
            try:
                for cmd in tries:
                    done = subprocess.run(cmd, capture_output=True,
                                          timeout=300)
                    if done.returncode == 0:
                        break
                else:
                    return False
                os.replace(os.path.join(native_dir, tmp), lib_path)
            finally:
                if os.path.exists(os.path.join(native_dir, tmp)):
                    os.unlink(os.path.join(native_dir, tmp))
        return os.path.exists(lib_path)
    except Exception:
        return False


def open_library(native_dir: str = _NATIVE_DIR) -> Optional[ctypes.CDLL]:
    """native_dir's libdrt_native.so, built first if it is missing; None if
    it cannot be built or loaded."""
    lib_path = os.path.join(native_dir, "libdrt_native.so")
    if not os.path.exists(lib_path) and not _build(native_dir, lib_path):
        return None
    try:
        return ctypes.CDLL(lib_path)
    except OSError:
        return None


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        lib = open_library()
        if lib is None:
            return None
        lib.drt_parse_obj.restype = ctypes.c_void_p
        lib.drt_parse_obj.argtypes = [ctypes.c_char_p]
        lib.drt_mesh_error.restype = ctypes.c_char_p
        lib.drt_mesh_error.argtypes = [ctypes.c_void_p]
        lib.drt_mesh_counts.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_int64)] * 4
        lib.drt_mesh_fill.argtypes = [ctypes.c_void_p] + [
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ]
        lib.drt_mesh_free.argtypes = [ctypes.c_void_p]
        lib.drt_morton_argsort.argtypes = [
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ]
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u64 = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.drt_morton_codes.argtypes = [f64, ctypes.c_int64, u64]
        lib.drt_centroids.argtypes = [f64, i32, ctypes.c_int64, f64, f64]
        lib.drt_bake_object.argtypes = [
            f64, i32, i32, f64, ctypes.c_int32, i32, f64, i64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            f32, f32, f32, f32, f32, f32, f32, f32, f32,
            f32, f32, f32, i32, f64, f64]
        lib.drt_block_bounds.argtypes = [
            f64, f64, ctypes.c_int64, ctypes.c_int64, f32, f32]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def parse_obj(path: str):
    """Native OBJ parse -> MeshData; raises if the library is unavailable."""
    from distributed_raytracer_tpu_torch.models.objparse import Material, MeshData

    lib = load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    handle = lib.drt_parse_obj(path.encode())
    try:
        err = lib.drt_mesh_error(handle)
        if err:
            raise FileNotFoundError(err.decode())
        nv = ctypes.c_int64(); nn = ctypes.c_int64()
        nf = ctypes.c_int64(); nm = ctypes.c_int64()
        lib.drt_mesh_counts(handle, ctypes.byref(nv), ctypes.byref(nn),
                            ctypes.byref(nf), ctypes.byref(nm))
        verts = np.empty((nv.value, 3), np.float64)
        norms = np.empty((nn.value, 3), np.float64)
        fv = np.empty((nf.value, 3), np.int32)
        fn = np.empty((nf.value, 3), np.int32)
        fmat = np.empty((nf.value,), np.int32)
        mats = np.empty((nm.value, 10), np.float64)
        lib.drt_mesh_fill(handle, verts, norms, fv, fn, fmat, mats)
    finally:
        lib.drt_mesh_free(handle)

    materials: List[Material] = [
        Material(ka=tuple(row[0:3]), kd=tuple(row[3:6]),
                 ks=tuple(row[6:9]), ns=float(row[9]))
        for row in mats
    ]
    return MeshData(vertices=verts, normals=norms, faces_v=fv, faces_n=fn,
                    face_mat=fmat, materials=materials)


def morton_argsort(centroids: np.ndarray) -> Optional[np.ndarray]:
    """Native Morton argsort of (N, 3) float64 centroids; None if no lib."""
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(centroids, np.float64)
    order = np.empty((pts.shape[0],), np.int64)
    lib.drt_morton_argsort(pts, pts.shape[0], order)
    return order


def morton_codes(centroids: np.ndarray) -> Optional[np.ndarray]:
    """Native 21-bit Morton codes of (N, 3) float64 points; None if no lib."""
    lib = load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(centroids, np.float64)
    codes = np.empty((pts.shape[0],), np.uint64)
    lib.drt_morton_codes(pts, pts.shape[0], codes)
    return codes


def centroids(verts: np.ndarray, faces: np.ndarray,
              pos: np.ndarray) -> Optional[np.ndarray]:
    """World-space triangle centroids of one object; None if no lib."""
    lib = load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, np.float64)
    f = np.ascontiguousarray(faces, np.int32)
    out = np.empty((f.shape[0], 3), np.float64)
    lib.drt_centroids(v, f, f.shape[0], np.ascontiguousarray(pos, np.float64),
                      out)
    return out


class BakeOut:
    """Preallocated output block for the native bake: every per-triangle
    SceneArrays field plus the per-slot f64 AABBs (padding slots zero /
    inverted). One instance per bake; objects write disjoint slots."""

    def __init__(self, n_slots: int):
        z3 = lambda: np.zeros((n_slots, 3), np.float32)
        z1 = lambda: np.zeros((n_slots,), np.float32)
        self.p0, self.e1, self.e2, self.geo_n = z3(), z3(), z3(), z3()
        self.k_u, self.k_v = z3(), z3()
        self.n0, self.n1, self.n2 = z3(), z3(), z3()
        self.plane_d, self.c_u, self.c_v = z1(), z1(), z1()
        self.mat_id = np.zeros((n_slots,), np.int32)
        self.tri_lo = np.full((n_slots, 3), np.inf, np.float64)
        self.tri_hi = np.full((n_slots, 3), -np.inf, np.float64)


def bake_object(out: BakeOut, verts, faces_v, faces_n, norms, has_normals,
                face_mat, pos, slot_src, src_lo: int, src_hi: int) -> None:
    """Bake one object's triangles into `out` at the slots whose global
    source id falls in [src_lo, src_hi). Requires the library."""
    lib = load()
    assert lib is not None
    n_slots = slot_src.shape[0]
    lib.drt_bake_object(
        np.ascontiguousarray(verts, np.float64),
        np.ascontiguousarray(faces_v, np.int32),
        np.ascontiguousarray(faces_n, np.int32),
        np.ascontiguousarray(norms, np.float64),
        1 if has_normals else 0,
        np.ascontiguousarray(face_mat, np.int32),
        np.ascontiguousarray(pos, np.float64),
        np.ascontiguousarray(slot_src, np.int64),
        n_slots, src_lo, src_hi,
        out.p0, out.e1, out.e2, out.geo_n, out.plane_d,
        out.k_u, out.k_v, out.c_u, out.c_v,
        out.n0, out.n1, out.n2, out.mat_id, out.tri_lo, out.tri_hi)


def block_bounds(out: BakeOut, block_size: int):
    """(block_lo, block_hi) float32 leaf AABBs from the baked per-slot
    bounds. Requires the library."""
    lib = load()
    assert lib is not None
    n_slots = out.tri_lo.shape[0]
    nb = n_slots // block_size
    lo = np.empty((nb, 3), np.float32)
    hi = np.empty((nb, 3), np.float32)
    lib.drt_block_bounds(out.tri_lo, out.tri_hi, n_slots, block_size, lo, hi)
    return lo, hi

"""Build and load the package's CUDA kernels (csrc/*.cu) on first use.

Each source is compiled by `nvcc` into a shared library with a plain C
interface and loaded with ctypes: csrc/bsr_trace.cu (K1-K5) and
csrc/ring_trace.cu (K6, K7), both including csrc/pair_math.cuh and
csrc/chunk_grid.cuh, and csrc/stamp.cu (the tracer's device stamps, loaded
only while the tracer is on, utils/tracing.py). The
library lands in distributed_raytracer_tpu_torch/_build/ (listed in
.gitignore) under a name keyed by a hash of the source, the shared headers
and the flags, so an edited source rebuilds and an unchanged one loads the
library already built. `build_all()` runs one nvcc per source, all at
once. A failed build raises with nvcc's output; nothing falls back.

Builds are safe across processes (the ranks of a multi-process run load
the kernels at first use): a library is built under an exclusive `fcntl`
lock on its own lock file in _build/, into a temporary name that is then
renamed, and a process that takes the lock after another has built the
library loads that one. So one nvcc runs per library, and no process ever
loads a half-written file.

Importing this module builds nothing and needs no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# sm_90a: Hopper. No --use_fast_math (the hit test relies on IEEE division
# and NaN compares); -fmad=false keeps the pair math rounded exactly as the
# plain PyTorch version rounds it (see the note in csrc/bsr_trace.cu).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

_libs: dict = {}
# nvcc's output per library, kept for reports (ptxas prints each kernel's
# registers, shared memory and spills).
build_logs: dict = {}

_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "bsr_trace": {
        "drt_bsr_nearest": (_i32, [_p, _i64, _p, _p, _p, _p, _p, _p, _i32, _p,
                                   _p, _p, _p, _p, _p, _i32, _i32, _i32, _i32,
                                   _i32, _p]),
        "drt_bsr_any": (_i32, [_p, _i64, _p, _p, _p, _p, _p, _i32, _p, _p, _p,
                               _i32, _i32, _i32, _i32, _p]),
        "drt_bsr_nearest_mxu": (_i32, [_p, _i64, _p, _p, _p, _p, _p, _p, _p,
                                       _p, _i32, _p, _p, _p, _p, _p, _p,
                                       _i32, _i32, _i32, _i32, _p]),
        "drt_bsr_any_mxu": (_i32, [_p, _i64, _p, _p, _p, _p, _p, _p, _p,
                                   _i32, _p, _p, _p, _i32, _i32, _i32, _p]),
        "drt_cuda_error_string": (ctypes.c_char_p, [_i32]),
    },
    "ring_trace": {
        "drt_ring_seed_keys": (_i32, [_p, _i64, _i32, _p]),
        "drt_ring_nearest_step": (_i32, [_p, _i64, _p, _p, _i32, _i32, _p,
                                         _i32, _i32, _i32, _p]),
        "drt_ring_unpack_keys": (_i32, [_p, _p, _p, _i64, _i32, _p]),
        "drt_ring_any_step": (_i32, [_p, _i64, _p, _p, _i32, _i32, _p, _i32,
                                     _i32, _i32, _p]),
        "drt_cuda_error_string": (ctypes.c_char_p, [_i32]),
    },
    "stamp": {
        "drt_stamp": (_i32, [_p, _p, _i32, _i32, _i32, _i32, _p]),
        "drt_cuda_error_string": (ctypes.c_char_p, [_i32]),
    },
}
# One lock per library within a process (its lock file orders processes):
# two libraries build at once, one never twice.
_locks = {name: threading.Lock() for name in _SIGNATURES}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (CUDA_HOME is unset and no CUDA "
                           "toolkit is installed): the CUDA kernels cannot "
                           "be built")
    return nvcc


def _compile(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    nvcc = _nvcc()
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join((nvcc,) + NVCC_FLAGS).encode())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    with open(BUILD_DIR / f".lib{name}.lock", "a") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():            # another process built it meanwhile
            return out
        # Build into a temporary name and rename: no process ever finds a
        # half-written library under the final name.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src.name} "
                                   f"(exit {res.returncode}):\n{res.stderr}")
            build_logs[name] = res.stdout + res.stderr
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return out


def load_library(name: str = "bsr_trace") -> ctypes.CDLL:
    """The compiled csrc/<name>.cu as a ctypes library, building it first if
    needed, with argtypes/restype set for every exported function."""
    with _locks[name]:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.restype, f.argtypes = restype, argtypes
            _libs[name] = lib
        return lib


def build_all() -> None:
    """Build (or load) every library, one nvcc per source, all at once."""
    with ThreadPoolExecutor(len(_SIGNATURES)) as pool:
        list(pool.map(load_library, _SIGNATURES))


def launch(name: str, fn, *args) -> None:
    """Calls fn, a C entry of library `name` that launches a kernel and
    returns cudaGetLastError(); raises with CUDA's message if it is not 0
    (a refused launch never runs, and a synchronize would not report it)."""
    err = fn(*args)
    if err:
        msg = load_library(name).drt_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err} "
                           f"({msg})")

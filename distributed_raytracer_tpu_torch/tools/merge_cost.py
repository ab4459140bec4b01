"""What the nearest kernels' cross-block merge costs, on one CUDA card.

    python -m distributed_raytracer_tpu_torch.tools.merge_cost

The chunk grid merges each block's per-ray minimum into an int64 key per
ray with a 64-bit atomicMin (csrc/bsr_trace.cu). This builds the source
twice more, into a temporary directory: once with every merge counted (a
device counter beside each atomicMin) and once with the atomicMin replaced
by a plain store (wrong results, the same memory traffic without the
atomic). It records the three per-ray-origin nearest launches (K3n) of one
depth-2 render_bounced() of the 1920x1080 sphere grid
(instanced_grid(icosphere_scene(3), 4)), counts the atomics each issues,
and times each with the real build and the store build in turns (real,
store, store, real; CUDA events around 20 calls queued behind a sleep).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

_MERGE = "atomicMin(keys + ray.ray(tile, j), join_key(bt[j], bi[j]));"
_INCLUDE = '#include "pair_math.cuh"'
# The counted build: a device counter, bumped beside each atomicMin, and a C
# entry that resets or reads it.
_COUNTER = "\n__device__ unsigned long long g_merges;"
_READ = """
extern "C" unsigned long long drt_merges(int reset) {
  unsigned long long v = 0;
  if (reset) {
    cudaMemcpyToSymbol(g_merges, &v, sizeof v);
    return 0;
  }
  cudaMemcpyFromSymbol(&v, g_merges, sizeof v);
  return v;
}
"""


def _variant(src: str, kind: str) -> str:
    if kind == "store":
        return src.replace(_MERGE,
                           "keys[ray.ray(tile, j)] = join_key(bt[j], bi[j]);")
    return (src.replace(_INCLUDE, _INCLUDE + _COUNTER)
            .replace(_MERGE, _MERGE + " atomicAdd(&g_merges, 1ull);") + _READ)


def _build_variant(d: str, kind: str):
    from distributed_raytracer_tpu_torch.ops import _build

    src = (_build.CSRC / "bsr_trace.cu").read_text()
    if src.count(_MERGE) != 2 or src.count(_INCLUDE) != 1:
        raise RuntimeError("the merge in csrc/bsr_trace.cu is not the one "
                           "this tool edits")
    path = os.path.join(d, f"{kind}.cu")
    with open(path, "w") as f:
        f.write(_variant(src, kind))
    lib = os.path.join(d, f"lib{kind}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", lib, path], check=True,
                   capture_output=True)
    cdll = ctypes.CDLL(lib)
    for fn, (restype, argtypes) in _build._SIGNATURES["bsr_trace"].items():
        getattr(cdll, fn).restype = restype
        getattr(cdll, fn).argtypes = argtypes
    return cdll


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("merge_cost: CUDA is not available", file=sys.stderr)
        return 1
    from distributed_raytracer_tpu_torch.ops import _build, bsr_trace
    from distributed_raytracer_tpu_torch.ops.render_bvh import CulledRenderer
    from distributed_raytracer_tpu_torch.tools.kernel_ab import _events_ms
    from distributed_raytracer_tpu_torch.utils import scenes

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"gpu: {card}", flush=True)
    real = _build.load_library()
    with tempfile.TemporaryDirectory() as d:
        count, store = (_build_variant(d, k) for k in ("count", "store"))
    count.drt_merges.restype = ctypes.c_ulonglong
    count.drt_merges.argtypes = [ctypes.c_int]

    grid = scenes.instanced_grid(scenes.icosphere_scene(3), 4)
    renderer = CulledRenderer(grid, 1920, 1080, block_size="auto",
                              device="cuda")
    seen = []
    original = bsr_trace.bsr_nearest

    def record(*args, **kwargs):
        seen.append((args, kwargs))
        return original(*args, **kwargs)

    bsr_trace.bsr_nearest = record
    try:
        renderer.render_bounced(grid.camera, 2, block=True)
    finally:
        bsr_trace.bsr_nearest = original
    for bounce, (args, kwargs) in enumerate(seen):
        call = lambda: bsr_trace.bsr_nearest(*args, **kwargs)
        _build._libs["bsr_trace"] = count
        count.drt_merges(1)
        call()
        torch.cuda.synchronize()
        merges = count.drt_merges(0)
        times = []
        for kind, lib in (("real", real), ("store", store), ("store", store),
                          ("real", real)):
            _build._libs["bsr_trace"] = lib
            times.append(f"{kind} {_events_ms(call):.4f}")
        _build._libs["bsr_trace"] = real
        items = int(args[6].item())
        blocks = -(-items // bsr_trace.CHUNK)
        print(f"K3n bounce {bounce}: {items} items in {blocks} blocks; "
              f"{merges} atomics ({merges / args[0].shape[1]:.2f} per ray, "
              f"{merges / blocks:.1f} per block); device ms per call "
              + ", ".join(times), flush=True)
    print(f"gpu: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

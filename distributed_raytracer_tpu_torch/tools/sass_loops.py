"""Instruction mix of the traversal kernels' loops, from the SASS of the
built library, on a machine with the CUDA toolkit.

    python -m distributed_raytracer_tpu_torch.tools.sass_loops [REGEX]
        [--lib bsr_trace|ring_trace] [--mxu]

Builds (or loads) csrc/<lib>.cu (default bsr_trace) through ops/_build,
disassembles the library with `cuobjdump -sass` and prints, for every
kernel whose mangled name matches REGEX (default: the chunk kernels at
RPT = 4, i.e. rt = 512: K1-K3a, or the ring's K6 and K7), each loop (a
backward branch and the instructions from its target to it) with its
instruction count by opcode. The row loop is the innermost loop that holds
the pair math: unrolled by two, at RPT = 4 it covers two triangle rows x
four rays per thread, 8 pairs per pass.

--mxu takes the tensor-core kernels K4 and K5 at rt = 512 instead
(NT = 8 column tiles per warp, 8 warps). Their row loop is the loop over
16-row slices that holds the mma (HMMA): per pass a lane covers NT 16x8
tiles of 4 pairs each, so each loop holding HMMA is also given per 16x8
tile (a warp's instructions for one tile) and per pair (a lane's).
"""

from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys

_INS = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_BRA = re.compile(r"\bBRA\s+(0x[0-9a-f]+)")


def functions(sass: str) -> dict:
    """{mangled name: [(address, instruction text)]} of a cuobjdump dump."""
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        m = _INS.match(line)
        if m and name:
            out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def loops(ins: list) -> list:
    """[(first address, last address, Counter of opcodes)] per backward
    branch, innermost (shortest) first."""
    res = []
    for addr, text in ins:
        m = _BRA.search(text)
        if m and int(m.group(1), 16) < addr:
            lo = int(m.group(1), 16)
            ops = collections.Counter(
                re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
                for a, t in ins if lo <= a <= addr)
            res.append((lo, addr, ops))
    return sorted(res, key=lambda x: x[1] - x[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("regex", nargs="?",
                    default=r"(?<!mxu_)chunk(_kernel|s)ILi4E")
    ap.add_argument("--lib", default="bsr_trace",
                    choices=("bsr_trace", "ring_trace"))
    ap.add_argument("--mxu", action="store_true")
    a = ap.parse_args(argv)
    if a.mxu:
        a.regex = r"mxu_chunk_kernelILi8ELi8E"
    from distributed_raytracer_tpu_torch.ops import _build

    lib = _build._compile(a.lib)
    cuda = os.path.dirname(os.path.dirname(_build._nvcc()))
    sass = subprocess.run([os.path.join(cuda, "bin", "cuobjdump"), "-sass",
                           str(lib)], check=True, capture_output=True,
                          text=True).stdout
    for name, ins in functions(sass).items():
        if not re.search(a.regex, name):
            continue
        print(name)
        nt = re.search(r"mxu_chunk_kernelILi(\d+)E", name)
        for lo, hi, ops in loops(ins):
            n = sum(ops.values())
            per = (f" ({n / int(nt.group(1)):.1f} per 16x8 tile, "
                   f"{n / (4 * int(nt.group(1))):.1f} per pair)"
                   if nt and ops.get("HMMA") else "")
            print(f"  loop {lo:#x}-{hi:#x}: {n} instructions{per}; "
                  + ", ".join(f"{k} {v}" for k, v in ops.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The CUDA kernels' build (ops/_build.py) is safe across processes.

Two processes that load one library at once from a build directory without
it: exactly one runs the compiler, and both load a whole library. `nvcc`
is replaced by a stub that writes its output slowly (a small shared
library built with the system C compiler, copied in pieces), so a process
that found the file before it was whole would fail to load it, and a
second build would show in the stub's log.
"""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = """#!{python}
import sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(out + "\\n")
data = open({lib!r}, "rb").read()
with open(out, "wb") as f:
    step = max(1, len(data) // 8)
    for i in range(0, len(data), step):
        f.write(data[i:i + step])
        f.flush()
        time.sleep(0.1)
"""

CHILD = """
import ctypes, sys
from pathlib import Path
from distributed_raytracer_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
_build._nvcc = lambda: sys.argv[2]
lib = ctypes.CDLL(str(_build._compile("bsr_trace")))
print(lib.stub_answer())
"""


def test_two_processes_build_one_library_once(tmp_path):
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("needs a C compiler to make the stub's library")
    src = tmp_path / "stub.c"
    src.write_text("int stub_answer(void) { return 42; }\n")
    lib = tmp_path / "libstub.so"
    subprocess.run([cc, "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, timeout=120)
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, log=str(log),
                                lib=str(lib)))
    stub.chmod(0o755)
    build = tmp_path / "_build"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(build),
                               str(stub)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert [o.strip() for o, _ in outs] == ["42", "42"]
    assert len(log.read_text().splitlines()) == 1
    left = sorted(n for n in os.listdir(build) if not n.startswith("."))
    assert len(left) == 1 and left[0].startswith("libbsr_trace-")

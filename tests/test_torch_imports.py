"""The PyTorch port imports no JAX, and importing it builds nothing."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every module of the package is imported; these must be among them.
MODULES = ["ops.render", "ops.intersect", "ops.shade", "ops.colour",
           "ops.raygen", "ops.ring_trace", "ops.bsr_trace", "parallel",
           "parallel.mesh", "parallel.tile", "parallel.render_sharded",
           "parallel.ring", "run", "utils.trace_cases", "tools.kernel_ab",
           "tools.merge_cost", "tools.sass_loops", "ops.frozen_graph",
           "runtime.controller", "runtime.loop", "runtime.viewer",
           "parallel.render_sharded_bvh", "parallel.halo",
           "parallel.halo_bvh", "parallel.ring_bvh", "parallel.multihost",
           "utils.oracle", "tools.multihost_worker", "utils.profiling",
           "tools.bake_cache", "tools.config_ab", "tools.xprof",
           "tools.loop_recovery_smoke", "bench"]

CHECK = """
import importlib, pkgutil, sys
import distributed_raytracer_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
want = ["distributed_raytracer_tpu_torch." + m for m in %r]
assert not set(want) - set(names), sorted(set(want) - set(names))
assert len(names) >= 55, names
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib",
                                            "distributed_raytracer_tpu.")))
assert not bad, bad
from distributed_raytracer_tpu_torch.ops import _build
assert not _build._libs
print("imported", len(names))
""" % (MODULES,)


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", CHECK], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.startswith("imported")

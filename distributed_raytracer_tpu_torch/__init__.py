"""distributed_raytracer_tpu_torch — the renderer in PyTorch and CUDA.

The port of distributed_raytracer_tpu (JAX, Pallas kernels on a TPU) to
PyTorch, with its traversal kernels written by hand in CUDA C++ for NVIDIA
Hopper. The JAX package stays beside it as the reference this package is
tested against. This package imports torch, numpy and the standard library,
never jax.

Layout (each module mirrors the JAX package's module of the same path):
  models/    camera, OBJ/MTL meshes, scenes, the block BVH bake (numpy)
  ops/       ray generation, culling, shading, the dense and culled
             renderers (torch); ops/bsr_trace.py and ops/ring_trace.py hold
             the kernels' wrappers and plain versions, csrc/ their CUDA
             source
  parallel/  ranks as an explicit device list (mesh.py), the ray-sharded
             dense renderer and the geometry ring
  runtime/   framebuffer output, FPS statistics, camera animation
  utils/     config and procedural scenes
  run.py     the command-line renderer (python -m distributed_raytracer_tpu_torch)

Importing the package imports nothing heavy and builds nothing.
"""

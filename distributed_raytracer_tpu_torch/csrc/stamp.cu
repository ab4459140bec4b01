// Device stage stamps: one thread writes the card's %globaltimer (ns) into
// a ring of rows, so marks captured inside a CUDA graph say when each stage
// of a replayed frame ran (utils/tracing.py).
//
// Replaces no TPU kernel: the JAX package's frames are one jitted dispatch
// and its profiler names the fused ops; a captured graph here runs several
// hundred launches that the profiler names only by the library's kernel
// names, so the stage boundaries are written by the frame itself.
//
// Bound: one 8-byte store and, for the row's last point, one 4-byte counter
// update: latency, not throughput (one block of one thread, about the cost
// of an empty launch). The row comes from a device-side slot counter that
// the last point of a row advances, so a replayed graph writes a new row
// each frame with no host work; rows wrap after `capacity`.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void stamp_kernel(long long* ring, int* slot, int capacity,
                             int width, int point, int last) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const int s = *slot;
  ring[(long long)s * width + point] = (long long)t;
  if (last) *slot = (s + 1) % capacity;
}

extern "C" int drt_stamp(void* ring, void* slot, int capacity, int width,
                         int point, int last, void* stream) {
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)ring, (int*)slot, capacity, width, point, last);
  return (int)cudaGetLastError();
}

extern "C" const char* drt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

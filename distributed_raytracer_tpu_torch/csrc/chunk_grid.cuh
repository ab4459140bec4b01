// Device helpers of the item-chunk grid kernels: bsr_trace.cu's K1-K5 and
// ring_trace.cu's K6, K7. The grids run blocks over chunks of (ray tile,
// triangle block) items (128 threads for K1-K3a, K6, K7; the tensor-core
// K4/K5 take more), stage each item's rows into a two-slot ring in shared
// memory with cp.async, and merge nearest hits across blocks through an
// int64 key per ray.

#pragma once

#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // threads per block of the chunk kernels

// The plain version's key: (bits(t + 0.0) << 32) | id, the id sign-extended
// as torch's int64 cast does. For t >= 0 or inf and 0 <= id < 2^31 it
// orders pairs as (t, id) lexicographically; adding 0.0 turns -0.0 into
// +0.0, which compare equal.
__device__ __forceinline__ long long make_key(float t, int id) {
  const unsigned long long hi =
      (unsigned long long)(unsigned)__float_as_int(__fadd_rn(t, 0.0f)) << 32;
  return (long long)(hi | (unsigned long long)(long long)id);
}

// A key's halves as (t, id) registers, and back, bit for bit.
__device__ __forceinline__ void split_key(long long k, float* t, int* id) {
  *t = __int_as_float((int)((unsigned long long)k >> 32));
  *id = (int)(unsigned)k;
}

__device__ __forceinline__ long long join_key(float t, int id) {
  return (long long)(((unsigned long long)(unsigned)__float_as_int(t) << 32) |
                     (unsigned)id);
}

// Issues the 16-byte copies of n float4 from src to dst, kBlock threads
// striding.
template <int kBlock>
__device__ __forceinline__ void copy_async(const float4* __restrict__ src,
                                           int n, float4* dst) {
  for (int k = threadIdx.x; k < n; k += kBlock) {
    const unsigned to = (unsigned)__cvta_generic_to_shared(dst + k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(to),
                 "l"(src + k)
                 : "memory");
  }
}

// Issues the copies of n float4 from src to dst and, when n2 > 0, those of
// a second source (the tensor-core form's scalar block beside its A block)
// into its own destination, as one commit group.
template <int kBlock = kThreads>
__device__ __forceinline__ void stage_async(const float4* __restrict__ src,
                                            int n, float4* dst,
                                            const float4* __restrict__ src2 =
                                                nullptr,
                                            int n2 = 0,
                                            float4* dst2 = nullptr) {
  copy_async<kBlock>(src, n, dst);
  if (n2 > 0) copy_async<kBlock>(src2, n2, dst2);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Triangle block `block` (tb rows of four float4) into a ring slot.
__device__ __forceinline__ void stage_async(const float4* __restrict__ tris,
                                            int block, int tb, float4* slot) {
  stage_async(tris + (int64_t)block * tb * 4, tb * 4, slot);
}

// Waits for this thread's copies; the __syncthreads that follows makes
// every thread's copies visible.
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

}  // namespace

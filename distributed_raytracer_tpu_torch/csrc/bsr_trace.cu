// Block-sparse ray-triangle traversal kernels for Hopper (sm_90a).
//
// What each function replaces (distributed_raytracer_tpu/ops/pallas/bsr_trace.py):
//   nearest_kernel  <- _nearest_kernel with _pair_math(shared_origin=True)
//                      (K1, reached through bsr_nearest; primary rays)
//   any_kernel      <- _any_kernel with _pair_math(shared_origin=True)
//                      (K2, reached through bsr_any; all lights' shadow
//                      rays in one launch)
//
// Both walk a flat, tile-major work list of (ray tile of rt rays, triangle
// block of tb triangles) items made by ops/cull.py and evaluate the
// Baldwin-Weber test for every (ray, triangle) pair of each item. The
// triangle rows are the pack_tris_origin layout: per triangle 16 floats
// [nx ny nz num | kux kuy kuz a_u | kvx kvy kvz a_v | 0 0 0 0], with the
// launch's common ray origin already folded into num / a_u / a_v.
//
// What bounds them on this card: the pair math is about 40 FP32 operations
// per (ray, triangle) pair (15 multiply-adds for the three direction dots,
// one division, the products with t and seven compares), against 48 bytes
// of triangle data shared by all rt rays of the tile: a tb = 64 block is
// 3 KB (4 KB as staged, with its zero columns), re-read once per work item
// by one thread block. So the kernels are bound by FP32 instruction
// throughput and the division, not by memory: one item is rt * tb = 32K
// pairs for 4 KB read.
//
// The design for that, simple first:
//   - One thread block of 128 threads per ray tile (grid = number of ray
//     tiles). Each thread owns rt / 128 rays and keeps their best t / best
//     id (or hit flag) in registers, seeded from init.
//   - The work list is sorted by tile, so a block finds its own contiguous
//     run of items with a binary search over tile_ids[0, min(count, W)).
//     `count` is read from device memory: the host never learns it.
//   - Per item the block stages the triangle block in shared memory (tb
//     float4 rows of 4, 16-byte loads), then each thread tests its rays
//     against all tb triangles: a shared-memory read is a broadcast, and
//     each triangle's 12 floats serve rt / 128 rays from registers.
//   - Early exit (exit_every = K > 0): after every K items, the nearest
//     kernel takes the block-wide max of the best t and skips later items
//     whose conservative entry distance exceeds it by more than 1e-4; the
//     any-hit kernel stops once __syncthreads_and says every ray is hit.
//     Both skips are exact: a skipped item cannot win or tie.
//   - Every ray of every tile is written; tiles without items keep init
//     (the TPU kernel left them undefined; callers mask them either way).
//   - No TMA, no wgmma, no persistent blocks yet.
//
// Numerics. Built without --use_fast_math: the validity test relies on IEEE
// division by a zero den (inf or NaN) and on NaN comparing false. Built with
// -fmad=false: otherwise nvcc contracts nx*dx + ny*dy + nz*dz into fused
// multiply-adds, which round once instead of twice and would make t, u and
// v differ from the plain PyTorch version (and the JAX reference) in the
// last bit, flipping hit decisions on shared edges. With it, the pair math
// below is the operation order of _pair_math (bsr_trace.py:236-240),
// rounded after every operation, and matches the plain version bit for bit.
//
// The C interface returns cudaGetLastError() after the launch; the launch
// is asynchronous on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
// ops/intersect.py BARY_EPS, rounded as the Python float is rounded to f32.
constexpr float kEps = (float)1e-4;
constexpr float kOneEps = (float)(1.0 + 1e-4);
constexpr float kExitSlack = (float)1e-4;  // guards f32 interval math

// Baldwin-Weber for one (triangle, ray) pair, shared-origin form.
// a = (nx, ny, nz, num), b = (kux, kuy, kuz, a_u), c = (kvx, kvy, kvz, a_v).
__device__ __forceinline__ bool pair_math(const float4 a, const float4 b,
                                          const float4 c, float dx, float dy,
                                          float dz, float* t_out) {
  const float den = a.x * dx + a.y * dy + a.z * dz;
  const float t = a.w / den;
  const float u = b.w + t * (b.x * dx + b.y * dy + b.z * dz);
  const float v = c.w + t * (c.x * dx + c.y * dy + c.z * dz);
  *t_out = t;
  const float uv = u + v;
  return (den != 0.0f) & (t >= 0.0f) & (u >= -kEps) & (u <= kOneEps) &
         (uv >= -kEps) & (uv <= kOneEps) & (v >= -kEps);
}

// First index in [lo, hi) with a[i] >= key (a ascending).
__device__ int lower_bound(const int* __restrict__ a, int lo, int hi,
                           int key) {
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (a[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// This tile's run [lo, hi) of live work items (slots < min(count, W)).
__device__ void find_run(const int* __restrict__ tile_ids,
                         const int* __restrict__ count, int n_items, int tile,
                         int* run) {
  if (threadIdx.x == 0) {
    const int n = min(max(*count, 0), n_items);
    const int lo = lower_bound(tile_ids, 0, n, tile);
    run[0] = lo;
    run[1] = lower_bound(tile_ids, lo, n, tile + 1);
  }
  __syncthreads();
}

__device__ __forceinline__ void stage_block(const float4* __restrict__ tris,
                                            int block, int tb, float4* tri_s) {
  const float4* src = tris + (int64_t)block * tb * 4;
  for (int k = threadIdx.x; k < tb * 4; k += kThreads) tri_s[k] = src[k];
  __syncthreads();
}

template <int RPT>
__global__ void __launch_bounds__(kThreads)
    nearest_kernel(const float* __restrict__ rays, int64_t n_rays,
                   const int* __restrict__ excl,
                   const float4* __restrict__ tris,
                   const int* __restrict__ tile_ids,
                   const int* __restrict__ block_ids,
                   const float* __restrict__ entry,
                   const int* __restrict__ count, int n_items,
                   const float* __restrict__ init_t,
                   const int* __restrict__ init_i,
                   const int* __restrict__ gid_base,
                   float* __restrict__ out_t, int* __restrict__ out_i, int tb,
                   int exit_every) {
  extern __shared__ float4 tri_s[];
  __shared__ int run[2];
  __shared__ float warp_max[kThreads / 32];

  const int tile = blockIdx.x;
  const int64_t first = (int64_t)tile * (kThreads * RPT) + threadIdx.x;
  float dx[RPT], dy[RPT], dz[RPT], bt[RPT];
  int bi[RPT], ex[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int64_t r = first + j * kThreads;
    dx[j] = rays[3 * n_rays + r];
    dy[j] = rays[4 * n_rays + r];
    dz[j] = rays[5 * n_rays + r];
    bt[j] = init_t[r];
    bi[j] = init_i[r];
    ex[j] = excl[r];
  }
  find_run(tile_ids, count, n_items, tile, run);
  const int lo = run[0], hi = run[1];
  const int gid0 = *gid_base;
  float bound = INFINITY;  // block-uniform
  int done = 0;

  for (int w = lo; w < hi; ++w) {
    // Front-to-back skip: every ray's best hit is nearer than this block.
    if (exit_every && !(entry[w] <= bound + kExitSlack)) continue;
    const int block = block_ids[w];
    stage_block(tris, block, tb, tri_s);
    const int g0 = gid0 + block * tb;
#pragma unroll 2
    for (int row = 0; row < tb; ++row) {
      const float4 a = tri_s[4 * row];
      const float4 b = tri_s[4 * row + 1];
      const float4 c = tri_s[4 * row + 2];
      const int g = g0 + row;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        float t;
        const bool valid = pair_math(a, b, c, dx[j], dy[j], dz[j], &t) &&
                           g != ex[j];
        const float cand = valid ? t : INFINITY;
        // Lexicographic (t, id) minimum: ties go to the lowest global id,
        // so the result does not depend on the order items are visited.
        if (cand < bt[j] || (cand == bt[j] && g < bi[j])) {
          bt[j] = cand;
          bi[j] = g;
        }
      }
    }
    __syncthreads();  // tri_s is overwritten by the next item
    if (exit_every && ++done % exit_every == 0) {
      float m = bt[0];
#pragma unroll
      for (int j = 1; j < RPT; ++j) m = fmaxf(m, bt[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
      __syncthreads();
      bound = warp_max[0];
#pragma unroll
      for (int k = 1; k < kThreads / 32; ++k) bound = fmaxf(bound, warp_max[k]);
      __syncthreads();  // warp_max is rewritten at the next refresh
    }
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int64_t r = first + j * kThreads;
    out_t[r] = bt[j];
    out_i[r] = bi[j];
  }
}

template <int RPT>
__global__ void __launch_bounds__(kThreads)
    any_kernel(const float* __restrict__ rays, int64_t n_rays,
               const int* __restrict__ excl, const float4* __restrict__ tris,
               const int* __restrict__ tile_ids,
               const int* __restrict__ block_ids,
               const int* __restrict__ count, int n_items,
               const int* __restrict__ init, const int* __restrict__ gid_base,
               int* __restrict__ out, int tb, int exit_every) {
  extern __shared__ float4 tri_s[];
  __shared__ int run[2];

  const int tile = blockIdx.x;
  const int64_t first = (int64_t)tile * (kThreads * RPT) + threadIdx.x;
  float dx[RPT], dy[RPT], dz[RPT], tmax[RPT];
  int hit[RPT], ex[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int64_t r = first + j * kThreads;
    dx[j] = rays[3 * n_rays + r];
    dy[j] = rays[4 * n_rays + r];
    dz[j] = rays[5 * n_rays + r];
    tmax[j] = rays[6 * n_rays + r];
    hit[j] = init[r];
    ex[j] = excl[r];
  }
  find_run(tile_ids, count, n_items, tile, run);
  const int lo = run[0], hi = run[1];
  const int gid0 = *gid_base;
  int done = 0;

  for (int w = lo; w < hi; ++w) {
    const int block = block_ids[w];
    stage_block(tris, block, tb, tri_s);
    const int g0 = gid0 + block * tb;
#pragma unroll 2
    for (int row = 0; row < tb; ++row) {
      const float4 a = tri_s[4 * row];
      const float4 b = tri_s[4 * row + 1];
      const float4 c = tri_s[4 * row + 2];
      const int g = g0 + row;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (hit[j]) continue;  // an occluded ray stays occluded
        float t;
        if (pair_math(a, b, c, dx[j], dy[j], dz[j], &t) && g != ex[j] &&
            t <= tmax[j])
          hit[j] = 1;
      }
    }
    __syncthreads();  // tri_s is overwritten by the next item
    if (exit_every && ++done % exit_every == 0) {
      int all = 1;
#pragma unroll
      for (int j = 0; j < RPT; ++j) all &= hit[j] != 0;
      if (__syncthreads_and(all)) break;  // every ray of the tile is hit
    }
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) out[first + j * kThreads] = hit[j];
}

template <int RPT>
cudaError_t launch_nearest(const float* rays, int64_t n_rays, const int* excl,
                           const float* tris, const int* tile_ids,
                           const int* block_ids, const float* entry,
                           const int* count, int n_items, const float* init_t,
                           const int* init_i, const int* gid_base,
                           float* out_t, int* out_i, int tb, int exit_every,
                           cudaStream_t stream) {
  const int n_tiles = (int)(n_rays / (kThreads * RPT));
  const size_t smem = (size_t)tb * 16 * sizeof(float);
  nearest_kernel<RPT><<<n_tiles, kThreads, smem, stream>>>(
      rays, n_rays, excl, reinterpret_cast<const float4*>(tris), tile_ids,
      block_ids, entry, count, n_items, init_t, init_i, gid_base, out_t,
      out_i, tb, exit_every);
  return cudaGetLastError();
}

template <int RPT>
cudaError_t launch_any(const float* rays, int64_t n_rays, const int* excl,
                       const float* tris, const int* tile_ids,
                       const int* block_ids, const int* count, int n_items,
                       const int* init, const int* gid_base, int* out, int tb,
                       int exit_every, cudaStream_t stream) {
  const int n_tiles = (int)(n_rays / (kThreads * RPT));
  const size_t smem = (size_t)tb * 16 * sizeof(float);
  any_kernel<RPT><<<n_tiles, kThreads, smem, stream>>>(
      rays, n_rays, excl, reinterpret_cast<const float4*>(tris), tile_ids,
      block_ids, count, n_items, init, gid_base, out, tb, exit_every);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rays per thread is a template parameter: rt must be 128, 256, 512 or 1024.
// The Python wrapper (ops/bsr_trace.py) checks every shape, dtype, device,
// alignment and contiguity before calling.
int drt_bsr_nearest(const float* rays, int64_t n_rays, const int* excl,
                    const float* tris, const int* tile_ids,
                    const int* block_ids, const float* entry, const int* count,
                    int n_items, const float* init_t, const int* init_i,
                    const int* gid_base, float* out_t, int* out_i, int rt,
                    int tb, int exit_every, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rt) {
    case 128:
      return launch_nearest<1>(rays, n_rays, excl, tris, tile_ids, block_ids,
                               entry, count, n_items, init_t, init_i, gid_base,
                               out_t, out_i, tb, exit_every, s);
    case 256:
      return launch_nearest<2>(rays, n_rays, excl, tris, tile_ids, block_ids,
                               entry, count, n_items, init_t, init_i, gid_base,
                               out_t, out_i, tb, exit_every, s);
    case 512:
      return launch_nearest<4>(rays, n_rays, excl, tris, tile_ids, block_ids,
                               entry, count, n_items, init_t, init_i, gid_base,
                               out_t, out_i, tb, exit_every, s);
    case 1024:
      return launch_nearest<8>(rays, n_rays, excl, tris, tile_ids, block_ids,
                               entry, count, n_items, init_t, init_i, gid_base,
                               out_t, out_i, tb, exit_every, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int drt_bsr_any(const float* rays, int64_t n_rays, const int* excl,
                const float* tris, const int* tile_ids, const int* block_ids,
                const int* count, int n_items, const int* init,
                const int* gid_base, int* out, int rt, int tb, int exit_every,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rt) {
    case 128:
      return launch_any<1>(rays, n_rays, excl, tris, tile_ids, block_ids,
                           count, n_items, init, gid_base, out, tb, exit_every,
                           s);
    case 256:
      return launch_any<2>(rays, n_rays, excl, tris, tile_ids, block_ids,
                           count, n_items, init, gid_base, out, tb, exit_every,
                           s);
    case 512:
      return launch_any<4>(rays, n_rays, excl, tris, tile_ids, block_ids,
                           count, n_items, init, gid_base, out, tb, exit_every,
                           s);
    case 1024:
      return launch_any<8>(rays, n_rays, excl, tris, tile_ids, block_ids,
                           count, n_items, init, gid_base, out, tb, exit_every,
                           s);
    default:
      return cudaErrorInvalidValue;
  }
}

const char* drt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Block-sparse ray-triangle traversal kernels for Hopper (sm_90a).
//
// What each function replaces (distributed_raytracer_tpu/ops/pallas/bsr_trace.py):
//   nearest_kernel<RPT, true>   <- _nearest_kernel with _pair_math(shared_origin=True)
//                                  (K1, reached through bsr_nearest; primary rays)
//   any_kernel<RPT, true>       <- _any_kernel with _pair_math(shared_origin=True)
//                                  (K2, reached through bsr_any; all lights' shadow
//                                  rays in one launch)
//   nearest_kernel<RPT, false>  <- _nearest_kernel with _pair_math(shared_origin=False)
//                                  (K3n: every nearest query of the bounced frame,
//                                  whose reflection rays each have their own origin)
//   any_kernel<RPT, false>      <- _any_kernel with _pair_math(shared_origin=False)
//                                  (K3a: per-ray-origin any hit; the renderer has no
//                                  caller for it, shadows reverse to the light)
//
// All walk a flat, tile-major work list of (ray tile of rt rays, triangle
// block of tb triangles) items made by ops/cull.py and evaluate the
// Baldwin-Weber test for every (ray, triangle) pair of each item. Triangle
// rows are 16 floats [nx ny nz w | kux kuy kuz w_u | kvx kvy kvz w_v | 0 0 0 0].
// With a shared origin (kShared) they are the pack_tris_origin layout: the
// launch's common ray origin is folded in, w = plane_d - n.o, w_u = ku.o + c_u,
// w_v = kv.o + c_v. Otherwise they are the static pack_tris layout
// (w = plane_d, w_u = c_u, w_v = c_v) and each ray's origin is read from ray
// rows 0..2 and dotted in per pair.
//
// What bounds them on this card: the shared-origin pair math is about 30
// FP32 operations per (ray, triangle) pair (15 multiply-adds for the three
// direction dots, one division, the products with t, eight compares) and
// the fold; per-ray origins add about 18 (three origin dots and their
// folds). Against that, 48 bytes of triangle data are shared by all rt rays
// of the tile: a tb = 64 block is 3 KB (4 KB as staged, with its zero
// columns), re-read once per work item by one thread block. So the kernels
// are bound by FP32 instruction throughput and the division, not by
// memory: one item is rt * tb = 32K pairs for 4 KB read.
//
// The design for that, simple first:
//   - One thread block of 128 threads per ray tile (grid = number of ray
//     tiles). Each thread owns rt / 128 rays and keeps their direction (and
//     origin, without kShared), best t / best id (or hit flag) in registers,
//     seeded from init.
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
//   - The whole work list runs in one launch, however long (the TPU kernel
//     chained segments of 16,384 items).
//   - Every ray of every tile is written; tiles without items keep init
//     (the TPU kernel left them undefined; callers mask them either way).
//   - No TMA, no wgmma, no persistent blocks yet.
//
// Numerics. Built without --use_fast_math: the validity test relies on IEEE
// division by a zero den (inf or NaN) and on NaN comparing false (a dead
// ray, scattered back as a zero direction, has den == 0 against every
// triangle). Built with -fmad=false: otherwise nvcc contracts
// nx*dx + ny*dy + nz*dz into fused multiply-adds, which round once instead
// of twice and would make t, u and v differ from the plain PyTorch version
// (and the JAX reference) in the last bit, flipping hit decisions on shared
// edges. With it, the pair math below is the operation order of _pair_math
// (bsr_trace.py:236-248), rounded after every operation, and matches the
// plain version bit for bit. That matters most for the exclusion of the
// previous bounce's triangle, which keeps a reflection ray off its own
// surface only if both versions agree on every id.
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

// What every launch takes besides its accumulators.
struct WorkArgs {
  const float* rays;  // (8, n_rays) rows ox oy oz dx dy dz tmax 0
  int64_t n_rays;
  const int* excl;     // (n_rays,) triangle id each ray must not hit
  const float4* tris;  // (T, 16) rows as float4 quads
  const int* tile_ids;
  const int* block_ids;
  const float* entry;
  const int* count;  // live slots, on the device
  int n_items;       // W, the work list's length
  const int* gid_base;
  int tb;
  int exit_every;
};

// One thread's RPT rays: origins (per-ray form only) and directions.
template <int RPT, bool kShared>
struct RayRegs {
  float ox[RPT], oy[RPT], oz[RPT], dx[RPT], dy[RPT], dz[RPT];

  __device__ __forceinline__ void load(const WorkArgs& p, int64_t first) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int64_t r = first + j * kThreads;
      ox[j] = kShared ? 0.0f : p.rays[r];
      oy[j] = kShared ? 0.0f : p.rays[p.n_rays + r];
      oz[j] = kShared ? 0.0f : p.rays[2 * p.n_rays + r];
      dx[j] = p.rays[3 * p.n_rays + r];
      dy[j] = p.rays[4 * p.n_rays + r];
      dz[j] = p.rays[5 * p.n_rays + r];
    }
  }
};

// Baldwin-Weber for one (triangle, ray) pair.
// a = (nx, ny, nz, w), b = (kux, kuy, kuz, w_u), c = (kvx, kvy, kvz, w_v).
template <bool kShared>
__device__ __forceinline__ bool pair_math(const float4 a, const float4 b,
                                          const float4 c, float ox, float oy,
                                          float oz, float dx, float dy,
                                          float dz, float* t_out) {
  const float den = a.x * dx + a.y * dy + a.z * dz;
  float t, au, av;
  if (kShared) {
    t = a.w / den;
    au = b.w;
    av = c.w;
  } else {
    const float o_n = a.x * ox + a.y * oy + a.z * oz;
    t = (a.w - o_n) / den;
    au = (b.x * ox + b.y * oy + b.z * oz) + b.w;
    av = (c.x * ox + c.y * oy + c.z * oz) + c.w;
  }
  const float u = au + t * (b.x * dx + b.y * dy + b.z * dz);
  const float v = av + t * (c.x * dx + c.y * dy + c.z * dz);
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
__device__ void find_run(const WorkArgs& p, int tile, int* run) {
  if (threadIdx.x == 0) {
    const int n = min(max(*p.count, 0), p.n_items);
    const int lo = lower_bound(p.tile_ids, 0, n, tile);
    run[0] = lo;
    run[1] = lower_bound(p.tile_ids, lo, n, tile + 1);
  }
  __syncthreads();
}

__device__ __forceinline__ void stage_block(const float4* __restrict__ tris,
                                            int block, int tb, float4* tri_s) {
  const float4* src = tris + (int64_t)block * tb * 4;
  for (int k = threadIdx.x; k < tb * 4; k += kThreads) tri_s[k] = src[k];
  __syncthreads();
}

template <int RPT, bool kShared>
__global__ void __launch_bounds__(kThreads)
    nearest_kernel(const WorkArgs p, const float* __restrict__ init_t,
                   const int* __restrict__ init_i, float* __restrict__ out_t,
                   int* __restrict__ out_i) {
  extern __shared__ float4 tri_s[];
  __shared__ int run[2];
  __shared__ float warp_max[kThreads / 32];

  const int tile = blockIdx.x;
  const int64_t first = (int64_t)tile * (kThreads * RPT) + threadIdx.x;
  RayRegs<RPT, kShared> ray;
  ray.load(p, first);
  float bt[RPT];
  int bi[RPT], ex[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int64_t r = first + j * kThreads;
    bt[j] = init_t[r];
    bi[j] = init_i[r];
    ex[j] = p.excl[r];
  }
  find_run(p, tile, run);
  const int lo = run[0], hi = run[1];
  const int gid0 = *p.gid_base;
  float bound = INFINITY;  // block-uniform
  int done = 0;

  for (int w = lo; w < hi; ++w) {
    // Front-to-back skip: every ray's best hit is nearer than this block.
    if (p.exit_every && !(p.entry[w] <= bound + kExitSlack)) continue;
    const int block = p.block_ids[w];
    stage_block(p.tris, block, p.tb, tri_s);
    const int g0 = gid0 + block * p.tb;
#pragma unroll 2
    for (int row = 0; row < p.tb; ++row) {
      const float4 a = tri_s[4 * row];
      const float4 b = tri_s[4 * row + 1];
      const float4 c = tri_s[4 * row + 2];
      const int g = g0 + row;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        float t;
        const bool valid =
            pair_math<kShared>(a, b, c, ray.ox[j], ray.oy[j], ray.oz[j],
                               ray.dx[j], ray.dy[j], ray.dz[j], &t) &&
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
    if (p.exit_every && ++done % p.exit_every == 0) {
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

template <int RPT, bool kShared>
__global__ void __launch_bounds__(kThreads)
    any_kernel(const WorkArgs p, const int* __restrict__ init,
               int* __restrict__ out) {
  extern __shared__ float4 tri_s[];
  __shared__ int run[2];

  const int tile = blockIdx.x;
  const int64_t first = (int64_t)tile * (kThreads * RPT) + threadIdx.x;
  RayRegs<RPT, kShared> ray;
  ray.load(p, first);
  float tmax[RPT];
  int hit[RPT], ex[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int64_t r = first + j * kThreads;
    tmax[j] = p.rays[6 * p.n_rays + r];
    hit[j] = init[r];
    ex[j] = p.excl[r];
  }
  find_run(p, tile, run);
  const int lo = run[0], hi = run[1];
  const int gid0 = *p.gid_base;
  int done = 0;

  for (int w = lo; w < hi; ++w) {
    const int block = p.block_ids[w];
    stage_block(p.tris, block, p.tb, tri_s);
    const int g0 = gid0 + block * p.tb;
#pragma unroll 2
    for (int row = 0; row < p.tb; ++row) {
      const float4 a = tri_s[4 * row];
      const float4 b = tri_s[4 * row + 1];
      const float4 c = tri_s[4 * row + 2];
      const int g = g0 + row;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (hit[j]) continue;  // an occluded ray stays occluded
        float t;
        if (pair_math<kShared>(a, b, c, ray.ox[j], ray.oy[j], ray.oz[j],
                               ray.dx[j], ray.dy[j], ray.dz[j], &t) &&
            g != ex[j] && t <= tmax[j])
          hit[j] = 1;
      }
    }
    __syncthreads();  // tri_s is overwritten by the next item
    if (p.exit_every && ++done % p.exit_every == 0) {
      int all = 1;
#pragma unroll
      for (int j = 0; j < RPT; ++j) all &= hit[j] != 0;
      if (__syncthreads_and(all)) break;  // every ray of the tile is hit
    }
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) out[first + j * kThreads] = hit[j];
}

// Rays per thread (RPT = rt / 128) and the origin form are template
// parameters; these pick the instantiation for a launch.
using NearestFn = void (*)(WorkArgs, const float*, const int*, float*, int*);
using AnyFn = void (*)(WorkArgs, const int*, int*);

template <bool kShared>
NearestFn nearest_for(int rt) {
  switch (rt) {
    case 128: return nearest_kernel<1, kShared>;
    case 256: return nearest_kernel<2, kShared>;
    case 512: return nearest_kernel<4, kShared>;
    case 1024: return nearest_kernel<8, kShared>;
    default: return nullptr;
  }
}

template <bool kShared>
AnyFn any_for(int rt) {
  switch (rt) {
    case 128: return any_kernel<1, kShared>;
    case 256: return any_kernel<2, kShared>;
    case 512: return any_kernel<4, kShared>;
    case 1024: return any_kernel<8, kShared>;
    default: return nullptr;
  }
}

WorkArgs work_args(const float* rays, int64_t n_rays, const int* excl,
                   const float* tris, const int* tile_ids,
                   const int* block_ids, const float* entry, const int* count,
                   int n_items, const int* gid_base, int tb, int exit_every) {
  return WorkArgs{rays, n_rays, excl, reinterpret_cast<const float4*>(tris),
                  tile_ids, block_ids, entry, count, n_items, gid_base, tb,
                  exit_every};
}

}  // namespace

extern "C" {

// rt must be 128, 256, 512 or 1024; shared != 0 selects the shared-origin
// (pack_tris_origin) form, 0 the per-ray-origin (pack_tris) form. The
// Python wrapper (ops/bsr_trace.py) checks every shape, dtype, device,
// alignment and contiguity before calling.
int drt_bsr_nearest(const float* rays, int64_t n_rays, const int* excl,
                    const float* tris, const int* tile_ids,
                    const int* block_ids, const float* entry, const int* count,
                    int n_items, const float* init_t, const int* init_i,
                    const int* gid_base, float* out_t, int* out_i, int rt,
                    int tb, int exit_every, int shared, void* stream) {
  const NearestFn fn = shared ? nearest_for<true>(rt) : nearest_for<false>(rt);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const WorkArgs p = work_args(rays, n_rays, excl, tris, tile_ids, block_ids,
                               entry, count, n_items, gid_base, tb,
                               exit_every);
  const size_t smem = (size_t)tb * 16 * sizeof(float);
  fn<<<(int)(n_rays / rt), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, init_t, init_i, out_t, out_i);
  return cudaGetLastError();
}

int drt_bsr_any(const float* rays, int64_t n_rays, const int* excl,
                const float* tris, const int* tile_ids, const int* block_ids,
                const int* count, int n_items, const int* init,
                const int* gid_base, int* out, int rt, int tb, int exit_every,
                int shared, void* stream) {
  const AnyFn fn = shared ? any_for<true>(rt) : any_for<false>(rt);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const WorkArgs p = work_args(rays, n_rays, excl, tris, tile_ids, block_ids,
                               nullptr, count, n_items, gid_base, tb,
                               exit_every);
  const size_t smem = (size_t)tb * 16 * sizeof(float);
  fn<<<(int)(n_rays / rt), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      p, init, out);
  return cudaGetLastError();
}

const char* drt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

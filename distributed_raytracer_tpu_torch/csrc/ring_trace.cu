// Geometry-ring step kernels for Hopper (sm_90a): K6 and K7.
//
// What each function replaces (distributed_raytracer_tpu/ops/pallas/ring_trace.py):
//   ring_step_kernel<RPT, false>  <- _ring_kernel(any_hit=False) (K6, reached
//                                    through ring_nearest; the ring renderer's
//                                    primary rays, parallel/ring.py use_rdma=True)
//   ring_step_kernel<RPT, true>   <- _ring_kernel(any_hit=True) (K7, through
//                                    ring_any; its shadow rays, every light in
//                                    one rotation)
//
// The TPU kernel is the whole ring in one pallas_call over a grid of (ring
// step, ray tile, triangle block): each chip sends its resident triangle
// shard to the right neighbour with a remote DMA while it intersects the
// same shard, and semaphores (a capacity handshake, a neighbourhood
// barrier) order the double-buffered slots. On one card several ranks
// share the SMs, and a kernel that spins on a neighbour's semaphore can
// fill every SM while the neighbour's kernel waits to launch: a deadlock.
// So here one launch is ONE ring step of ONE rank: every resident ray
// against the shard in the rank's current slot, folded into the rank's
// accumulators in place. The rotation is ordered by the host, with CUDA
// events between per-rank compute and copy streams (ops/ring_trace.py,
// parallel/mesh.py); no kernel waits on another rank.
//
// A pair is _pair_math(shared_origin=False) (pair_math.cuh: the ring
// kernel's body, ring_trace.py:123-140, is that math) with the ray's own
// origin (rays rows 0..2) against the static pack_tris rows of the slot,
// and the global id gid = gid_base + row, gid_base = origin rank * T_loc.
// A pair hits when it passes the BARY_EPS bounds with den != 0, t >= 0 and
// gid != the ray's exclusion id.
//   K6: per ray the lexicographic minimum of (t, gid) over every pair, a
//       pair that misses counting as (inf, gid) (so a ray that hits nothing
//       ends at (inf, lowest gid), as in the TPU kernel), folded into
//       (acc_t, acc_i): ties go to the lowest global id, so the result does
//       not depend on the order in which the ranks visit the shards.
//   K7: acc |= (some pair hits with t <= t_max, rays row 6).
//
// What bounds them on this card: each pair is about 48 FP32 operations
// (six three-term dots, one division, two products with t, eight
// compares) and the fold, against 48 bytes of triangle data shared by all
// rays of a thread block: FP32 instruction throughput and the division
// bound them, as they bound K3n, not memory. A step of the 640x480 frame
// on 4 ranks is 76,800 rays x 5,120 triangles = 393 M pairs per rank.
//
// The design for that, simple first:
//   - One thread block of 128 threads per tile of rt rays (grid = R / rt);
//     each thread keeps its rt / 128 rays (origin, direction, t_max,
//     exclusion id) and accumulators in registers.
//   - The slot's rows are staged through shared memory 128 at a time (the
//     three used float4 quads of each row); a shared-memory read is a
//     broadcast, and each row serves rt / 128 rays from registers.
//   - K7 skips a ray once it is hit, and the block stops once every ray of
//     it is hit (__syncthreads_and at each staged chunk); both are exact.
//   - No TMA, no wgmma, no persistent blocks; the copy engines move the
//     shards, which is what lets a copy run under a kernel.
//
// Numerics: -fmad=false and no --use_fast_math (see pair_math.cuh), so K6
// equals its plain version (ring_nearest_ref) bit for bit, as K3n does.
//
// The C interface returns cudaGetLastError() after the launch; the launch
// is asynchronous on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pair_math.cuh"  // kEps, kOneEps, pair_math<kShared>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 128;  // triangle rows staged per pass

struct RingArgs {
  const float* rays;   // (8, n_rays) rows ox oy oz dx dy dz tmax 0
  int64_t n_rays;
  const int* excl;     // (n_rays,) global id each ray must not hit
  const float4* tris;  // (n_tris, 16) static pack_tris rows of the slot
  int n_tris;
  int gid_base;        // global id of the slot's row 0
};

// K6 (kAny = false): acc_t / acc_i, the running (t, gid) minimum.
// K7 (kAny = true): acc_i holds the 0/1 hit flags; acc_t is unused.
template <int RPT, bool kAny>
__global__ void __launch_bounds__(kThreads)
    ring_step_kernel(const RingArgs p, float* __restrict__ acc_t,
                     int* __restrict__ acc_i) {
  __shared__ float4 tri_s[kRows * 3];

  const int64_t first = (int64_t)blockIdx.x * (kThreads * RPT) + threadIdx.x;
  float ox[RPT], oy[RPT], oz[RPT], dx[RPT], dy[RPT], dz[RPT], tmax[RPT];
  float bt[RPT];
  int bi[RPT], ex[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int64_t r = first + j * kThreads;
    ox[j] = p.rays[r];
    oy[j] = p.rays[p.n_rays + r];
    oz[j] = p.rays[2 * p.n_rays + r];
    dx[j] = p.rays[3 * p.n_rays + r];
    dy[j] = p.rays[4 * p.n_rays + r];
    dz[j] = p.rays[5 * p.n_rays + r];
    tmax[j] = kAny ? p.rays[6 * p.n_rays + r] : 0.0f;
    bt[j] = kAny ? 0.0f : acc_t[r];
    bi[j] = acc_i[r];
    ex[j] = p.excl[r];
  }

  for (int r0 = 0; r0 < p.n_tris; r0 += kRows) {
    const int rows = min(kRows, p.n_tris - r0);
    const float4* src = p.tris + (int64_t)r0 * 4;
    for (int k = threadIdx.x; k < rows * 3; k += kThreads)
      tri_s[k] = src[(k / 3) * 4 + k % 3];
    __syncthreads();
#pragma unroll 2
    for (int row = 0; row < rows; ++row) {
      const float4 a = tri_s[3 * row];
      const float4 b = tri_s[3 * row + 1];
      const float4 c = tri_s[3 * row + 2];
      const int g = p.gid_base + r0 + row;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (kAny && bi[j]) continue;  // an occluded ray stays occluded
        float t;
        const bool valid = pair_math<false>(a, b, c, ox[j], oy[j], oz[j],
                                            dx[j], dy[j], dz[j], &t) &&
                           g != ex[j];
        if (kAny) {
          if (valid && t <= tmax[j]) bi[j] = 1;
        } else {
          const float cand = valid ? t : INFINITY;
          if (cand < bt[j] || (cand == bt[j] && g < bi[j])) {
            bt[j] = cand;
            bi[j] = g;
          }
        }
      }
    }
    if (kAny) {
      int all = 1;
#pragma unroll
      for (int j = 0; j < RPT; ++j) all &= bi[j] != 0;
      // Also the barrier before tri_s is overwritten.
      if (__syncthreads_and(all)) break;
    } else {
      __syncthreads();  // tri_s is overwritten by the next pass
    }
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int64_t r = first + j * kThreads;
    if (!kAny) acc_t[r] = bt[j];
    acc_i[r] = bi[j];
  }
}

using StepFn = void (*)(RingArgs, float*, int*);

// Rays per thread (RPT = rt / 128) is a template parameter.
template <bool kAny>
StepFn step_for(int rt) {
  switch (rt) {
    case 128: return ring_step_kernel<1, kAny>;
    case 256: return ring_step_kernel<2, kAny>;
    case 512: return ring_step_kernel<4, kAny>;
    default: return nullptr;
  }
}

cudaError_t launch(StepFn fn, const float* rays, int64_t n_rays,
                   const int* excl, const float* tris, int n_tris,
                   int gid_base, float* acc_t, int* acc_i, int rt, int device,
                   void* stream) {
  if (fn == nullptr || n_rays % rt) return cudaErrorInvalidValue;
  // The rank's card: ranks on several cards launch from one host thread.
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const RingArgs p{rays, n_rays, excl, reinterpret_cast<const float4*>(tris),
                   n_tris, gid_base};
  fn<<<(int)(n_rays / rt), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, acc_t, acc_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// One ring step of one rank, on `stream` of card `device`. rt must be 128,
// 256 or 512 and divide n_rays; tris is the rank's current slot,
// (n_tris, 16) floats, 16-byte aligned.
// The Python wrapper (ops/ring_trace.py) checks every shape, dtype, device,
// alignment and contiguity before calling.
int drt_ring_nearest_step(const float* rays, int64_t n_rays, const int* excl,
                          const float* tris, int n_tris, int gid_base,
                          float* acc_t, int* acc_i, int rt, int device,
                          void* stream) {
  return launch(step_for<false>(rt), rays, n_rays, excl, tris, n_tris,
                gid_base, acc_t, acc_i, rt, device, stream);
}

int drt_ring_any_step(const float* rays, int64_t n_rays, const int* excl,
                      const float* tris, int n_tris, int gid_base, int* acc,
                      int rt, int device, void* stream) {
  return launch(step_for<true>(rt), rays, n_rays, excl, tris, n_tris,
                gid_base, nullptr, acc, rt, device, stream);
}

const char* drt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

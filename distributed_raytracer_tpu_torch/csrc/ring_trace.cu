// Geometry-ring step kernels for Hopper (sm_90a): K6 and K7.
//
// What each function replaces (distributed_raytracer_tpu/ops/pallas/ring_trace.py):
//   ring_nearest_chunks<RPT>  <- _ring_kernel(any_hit=False) (K6, reached
//   + ring_seed_keys,            through ring_nearest; the ring renderer's
//     ring_unpack_keys           primary rays, parallel/ring.py use_rdma=True)
//   ring_any_chunks<RPT>      <- _ring_kernel(any_hit=True) (K7, through
//                                ring_any; its shadow rays, every light in
//                                one rotation)
//
// The TPU kernel is the whole ring in one pallas_call over a grid of (ring
// step, ray tile, triangle block): each chip sends its resident triangle
// shard to the right neighbour with a remote DMA while it intersects the
// same shard, and semaphores (a capacity handshake, a neighbourhood
// barrier) order the double-buffered slots. On one card several ranks
// share the SMs, and a kernel that spins on a neighbour's semaphore can
// fill every SM while the neighbour's kernel waits to launch: a deadlock.
// So here one chunk launch is ONE ring step of ONE rank: every resident ray
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
//   K6: per ray the lexicographic minimum of (t, gid) over every pair of
//       every step, a pair that misses counting as (inf, gid) (so a ray
//       that hits nothing ends at (inf, lowest gid) = (inf, 0), as in the
//       TPU kernel): ties go to the lowest global id, so the result does
//       not depend on the order in which the ranks visit the shards.
//   K7: 1 where some pair hits with t <= t_max (rays row 6), else 0.
//
// The design. A first version ran one block of 128 threads per ray tile,
// walking the whole slot: at the 640x480 4-rank step that is 150 blocks
// for K6 (450 for K7) on 132 SMs, about one warp per scheduler to hide the
// dependent FP32 chains and the IEEE division. So the grid is K1-K3a's
// (bsr_trace.cu) over each step's dense space:
//   - An item is (ray tile of rt rays, block of kRows = 128 slot rows),
//     indexed tile-major and implicitly: tile = w / nb, row block = w % nb,
//     nb = T_loc / 128. The ring is dense, so there is no work list.
//   - ceil(items / chunk) blocks of 128 threads; block b takes the items
//     [b*chunk, (b+1)*chunk) (ops/ring_trace.py CHUNK). A block holds one
//     ray tile at a time, rt / 128 rays per thread, in registers; where the
//     tile changes inside a chunk it flushes its rays and loads the next
//     tile's. The 640x480 4-rank step is 6,000 items (3,000 blocks at chunk
//     2) for K6 and 18,000 for K7: one rank's step fills the card.
//   - Staging is asynchronous, as in bsr_trace.cu: each item's 128 rows go
//     into a two-slot ring in shared memory as 16-byte cp.async copies, one
//     commit group per item; item w+1's rows are in flight while item w is
//     tested, and one __syncthreads per item publishes them.
//   - K6 merges blocks and steps through an int64 key per ray, the plain
//     version's (bits(t + 0.0) << 32) | gid, in a per-rank scratch:
//     ring_seed_keys writes (inf, BIG_IDX) once per query, every step's
//     blocks fold each ray over an item in registers (rows in increasing
//     gid, so a strict < keeps the lowest gid of a tie) and atomicMin the
//     rays whose key fell into the scratch once per tile run, and
//     ring_unpack_keys writes (best_t, best_gid) after the rank's last
//     step. Keys only fall, so the result is the plain version's bit for
//     bit whatever the schedule (a hit at t = -0.0 comes back as +0.0).
//   - K7 reads its rays' flags when it loads a tile (flags only rise: hits
//     of earlier steps and other blocks), stores 1 for each ray it finds
//     hit, votes in the item barrier (__syncthreads_and: a tile whose rays
//     are all hit skips its remaining items), skips an item for a warp
//     whose rays are all hit and leaves the row loop every 16 rows once
//     they are.
//   - K6's uniform-origin rows. The ring's primary rays all leave the
//     camera. When a block loads a tile, each thread compares the BIT
//     PATTERNS of its rays' origins with the tile's first ray's, and
//     __syncthreads_and makes that a block-uniform flag (float == would
//     take -0.0 for +0.0, which multiply to zeros of different sign).
//     Where it holds, after an item's rows arrive, thread k folds row k's
//     w, w_u and w_v in place, in pair_math<false>'s own operations and
//     order: w' = w - ((nx*ox + ny*oy) + nz*oz), w_u' = ((kux*ox + kuy*oy)
//     + kuz*oz) + w_u, w_v' likewise (bsr_trace._origin_scalars). The row
//     loop then runs pair_math<true>, 21 operations per pair instead of 39,
//     with the same bits. K7's shadow origins lie on the surfaces, so K7
//     takes no vote.
//
// Numerics: -fmad=false and no --use_fast_math (see pair_math.cuh), so K6
// and K7 equal their plain versions (ring_nearest_ref, ring_any_ref) bit
// for bit.
//
// The C interface returns cudaGetLastError() after the launch; launches are
// asynchronous on the caller's stream and allocate nothing (the key
// scratch comes from the wrapper).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "chunk_grid.cuh"  // kThreads, make_key, stage_async, ...
#include "pair_math.cuh"   // kEps, kOneEps, pair_math<kShared>

namespace {

constexpr int kRows = 128;           // slot rows per item (ring_trace.TB)
constexpr int kSlot4 = kRows * 4;    // float4 per staged item
constexpr int kBigIdx = 1 << 30;     // ops/bsr_trace.py BIG_IDX
constexpr int kElemThreads = 256;    // ring_seed_keys, ring_unpack_keys
static_assert(kRows == kThreads, "the fold gives each thread one row");

struct RingArgs {
  const float* rays;   // (8, n_rays) rows ox oy oz dx dy dz tmax 0
  int64_t n_rays;
  const int* excl;     // (n_rays,) global id each ray must not hit
  const float4* tris;  // (n_blocks * kRows, 16) static pack_tris rows
  int n_blocks;        // nb, row blocks of the slot
  int n_items;         // ray tiles * nb
  int gid_base;        // global id of the slot's row 0
};

// One thread's RPT rays of the block's current tile.
template <int RPT>
struct TileRays {
  float ox[RPT], oy[RPT], oz[RPT], dx[RPT], dy[RPT], dz[RPT];
  int ex[RPT];

  static __device__ __forceinline__ int64_t ray(int tile, int j) {
    return (int64_t)tile * (kThreads * RPT) + threadIdx.x + j * kThreads;
  }

  __device__ __forceinline__ void load(const RingArgs& p, int tile) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int64_t r = ray(tile, j);
      ox[j] = p.rays[r];
      oy[j] = p.rays[p.n_rays + r];
      oz[j] = p.rays[2 * p.n_rays + r];
      dx[j] = p.rays[3 * p.n_rays + r];
      dy[j] = p.rays[4 * p.n_rays + r];
      dz[j] = p.rays[5 * p.n_rays + r];
      ex[j] = p.excl[r];
    }
  }

  // The vote (block-uniform, a barrier): every ray of the tile has the
  // origin of the tile's first ray, o, bit for bit.
  __device__ __forceinline__ bool shared_origin(const RingArgs& p, int tile,
                                                float* o) const {
    const int64_t r0 = (int64_t)tile * (kThreads * RPT);
    o[0] = p.rays[r0];
    o[1] = p.rays[p.n_rays + r0];
    o[2] = p.rays[2 * p.n_rays + r0];
    int same = 1;
#pragma unroll
    for (int j = 0; j < RPT; ++j)
      same &= (__float_as_int(ox[j]) == __float_as_int(o[0])) &
              (__float_as_int(oy[j]) == __float_as_int(o[1])) &
              (__float_as_int(oz[j]) == __float_as_int(o[2]));
    return __syncthreads_and(same) != 0;
  }

  // Ray j against the row (a, b, c); with kShared the row holds the folded
  // origin terms and the ray's origin is not read.
  template <bool kShared>
  __device__ __forceinline__ bool pair(const float4 a, const float4 b,
                                       const float4 c, int j,
                                       float* t) const {
    return pair_math<kShared>(a, b, c, kShared ? 0.0f : ox[j],
                              kShared ? 0.0f : oy[j], kShared ? 0.0f : oz[j],
                              dx[j], dy[j], dz[j], t);
  }
};

// Thread k folds the shared origin o into row k of a staged item, in
// pair_math<false>'s operations and order.
__device__ __forceinline__ void fold_origin(float4* tri_s, const float* o) {
  float4* row = tri_s + 4 * threadIdx.x;
  const float4 a = row[0], b = row[1], c = row[2];
  row[0].w = a.w - (a.x * o[0] + a.y * o[1] + a.z * o[2]);
  row[1].w = (b.x * o[0] + b.y * o[1] + b.z * o[2]) + b.w;
  row[2].w = (c.x * o[0] + c.y * o[1] + c.z * o[2]) + c.w;
}

// The item's (t, gid) minimum per ray over its kRows rows; a pair that
// misses counts as (inf, gid), so an item without a hit gives (inf, g0).
template <bool kShared, int RPT>
__device__ __forceinline__ void nearest_item(const TileRays<RPT>& ray,
                                             const float4* tri_s, int g0,
                                             float (&it)[RPT],
                                             int (&ii)[RPT]) {
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    it[j] = INFINITY;
    ii[j] = g0;
  }
#pragma unroll 2
  for (int row = 0; row < kRows; ++row) {
    const float4 a = tri_s[4 * row];
    const float4 b = tri_s[4 * row + 1];
    const float4 c = tri_s[4 * row + 2];
    const int g = g0 + row;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float tt;
      if (ray.template pair<kShared>(a, b, c, j, &tt) && g != ray.ex[j] &&
          tt < it[j]) {
        it[j] = tt;
        ii[j] = g;
      }
    }
  }
}

__global__ void ring_seed_keys(long long* __restrict__ keys, int64_t n) {
  const int64_t r = (int64_t)blockIdx.x * kElemThreads + threadIdx.x;
  if (r < n) keys[r] = make_key(INFINITY, kBigIdx);
}

__global__ void ring_unpack_keys(const long long* __restrict__ keys,
                                 float* __restrict__ out_t,
                                 int* __restrict__ out_i, int64_t n) {
  const int64_t r = (int64_t)blockIdx.x * kElemThreads + threadIdx.x;
  if (r < n) split_key(keys[r], out_t + r, out_i + r);
}

template <int RPT>
__global__ void __launch_bounds__(kThreads)
    ring_nearest_chunks(const RingArgs p, int chunk,
                        long long* __restrict__ keys) {
  __shared__ float4 ring[2 * kSlot4];

  const int lo = (int)blockIdx.x * chunk;
  const int hi = min(lo + chunk, p.n_items);
  stage_async(p.tris, lo % p.n_blocks, kRows, ring);

  TileRays<RPT> ray;
  float bt[RPT];  // the rays' keys as (t, gid) halves
  int bi[RPT];
  unsigned changed = 0;  // bit j: ray j's key fell in this tile run
  int tile = -1;
  bool shared = false;  // block-uniform: the tile's rays share origin o
  float o[3];

  for (int w = lo; w < hi; ++w) {
    const int t = w / p.n_blocks;
    if (t != tile) {  // block-uniform
      if (tile >= 0) {
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          if (changed >> j & 1u)
            atomicMin(keys + ray.ray(tile, j), join_key(bt[j], bi[j]));
      }
      tile = t;
      ray.load(p, tile);
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        split_key(__ldcg(keys + ray.ray(tile, j)), &bt[j], &bi[j]);
      changed = 0;
      shared = ray.shared_origin(p, tile, o);
    }
    wait_staged();
    __syncthreads();  // item w's rows are in; the other slot is free
    if (w + 1 < hi)
      stage_async(p.tris, (w + 1) % p.n_blocks, kRows,
                  ring + ((w + 1 - lo) & 1) * kSlot4);
    float4* tri_s = ring + ((w - lo) & 1) * kSlot4;
    const int g0 = p.gid_base + (w % p.n_blocks) * kRows;
    float it[RPT];
    int ii[RPT];
    if (shared) {
      fold_origin(tri_s, o);
      __syncthreads();  // every row is folded
      nearest_item<true>(ray, tri_s, g0, it, ii);
    } else {
      nearest_item<false>(ray, tri_s, g0, it, ii);
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const long long k = make_key(it[j], ii[j]);
      if (k < join_key(bt[j], bi[j])) {
        split_key(k, &bt[j], &bi[j]);
        changed |= 1u << j;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    if (changed >> j & 1u)
      atomicMin(keys + ray.ray(tile, j), join_key(bt[j], bi[j]));
}

template <int RPT>
__global__ void __launch_bounds__(kThreads)
    ring_any_chunks(const RingArgs p, int chunk, int* __restrict__ acc) {
  __shared__ float4 ring[2 * kSlot4];

  const int lo = (int)blockIdx.x * chunk;
  const int hi = min(lo + chunk, p.n_items);
  stage_async(p.tris, lo % p.n_blocks, kRows, ring);

  TileRays<RPT> ray;
  float tmax[RPT];
  int hit[RPT];
  unsigned found = 0;  // bit j: ray j found hit in this tile run
  int tile = -1;

  for (int w = lo; w < hi; ++w) {
    const int t = w / p.n_blocks;
    if (t != tile) {  // block-uniform
      if (tile >= 0) {
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          if (found >> j & 1u) acc[ray.ray(tile, j)] = 1;
      }
      tile = t;
      ray.load(p, tile);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int64_t r = ray.ray(tile, j);
        tmax[j] = p.rays[6 * p.n_rays + r];
        hit[j] = __ldcg(acc + r);  // an earlier step's or block's hit
      }
      found = 0;
    }
    wait_staged();
    int all = 1;
#pragma unroll
    for (int j = 0; j < RPT; ++j) all &= hit[j] != 0;
    // Item w's rows are in, the other slot is free, and the vote: once
    // every ray of the tile is hit, its later items change nothing.
    const int tile_done = __syncthreads_and(all);
    if (w + 1 < hi)
      stage_async(p.tris, (w + 1) % p.n_blocks, kRows,
                  ring + ((w + 1 - lo) & 1) * kSlot4);
    if (tile_done || __all_sync(0xffffffffu, all)) continue;
    const float4* tri_s = ring + ((w - lo) & 1) * kSlot4;
    const int g0 = p.gid_base + (w % p.n_blocks) * kRows;
#pragma unroll 2
    for (int row = 0; row < kRows; ++row) {
      const float4 a = tri_s[4 * row];
      const float4 b = tri_s[4 * row + 1];
      const float4 c = tri_s[4 * row + 2];
      const int g = g0 + row;
      int rest = 0;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (hit[j]) continue;  // an occluded ray stays occluded
        float tt;
        if (ray.template pair<false>(a, b, c, j, &tt) && g != ray.ex[j] &&
            tt <= tmax[j]) {
          hit[j] = 1;
          found |= 1u << j;
        }
        rest |= hit[j] == 0;
      }
      // The warp leaves the item once all of its rays are hit.
      if ((row & 15) == 15 && !__any_sync(0xffffffffu, rest)) break;
    }
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    if (found >> j & 1u) acc[ray.ray(tile, j)] = 1;
}

// Rays per thread (RPT = rt / 128) is a template parameter.
using NearestFn = void (*)(RingArgs, int, long long*);
using AnyFn = void (*)(RingArgs, int, int*);

NearestFn nearest_for(int rt) {
  switch (rt) {
    case 128: return ring_nearest_chunks<1>;
    case 256: return ring_nearest_chunks<2>;
    case 512: return ring_nearest_chunks<4>;
    default: return nullptr;
  }
}

AnyFn any_for(int rt) {
  switch (rt) {
    case 128: return ring_any_chunks<1>;
    case 256: return ring_any_chunks<2>;
    case 512: return ring_any_chunks<4>;
    default: return nullptr;
  }
}

// Checks a step's shapes, selects the rank's card (ranks on several cards
// launch from one host thread) and gives the launch's arguments and grid.
cudaError_t step_args(const float* rays, int64_t n_rays, const int* excl,
                      const float* tris, int n_tris, int gid_base, int rt,
                      int chunk, int device, RingArgs* p, unsigned* blocks) {
  if (rt % kThreads || n_rays % rt || n_tris % kRows || chunk < 1)
    return cudaErrorInvalidValue;
  const int64_t items = (n_rays / rt) * (int64_t)(n_tris / kRows);
  if (items + chunk > INT_MAX) return cudaErrorInvalidValue;
  *p = RingArgs{rays, n_rays, excl, reinterpret_cast<const float4*>(tris),
                n_tris / kRows, (int)items, gid_base};
  *blocks = (unsigned)((items + chunk - 1) / chunk);
  return cudaSetDevice(device);
}

unsigned elem_blocks(int64_t n) {
  return (unsigned)((n + kElemThreads - 1) / kElemThreads);
}

}  // namespace

extern "C" {

// The Python wrapper (ops/ring_trace.py) checks every shape, dtype, device,
// alignment and contiguity before calling. Every call enqueues on `stream`
// of card `device`; rt must be 128, 256 or 512 and divide n_rays; tris is
// the rank's current slot, (n_tris, 16) floats with n_tris a multiple of
// 128, 16-byte aligned; `chunk` >= 1 items per block.

// K6, once per rank and query, before its first step: keys (n,) int64 :=
// the key of (inf, BIG_IDX).
int drt_ring_seed_keys(long long* keys, int64_t n, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n > 0)
    ring_seed_keys<<<elem_blocks(n), kElemThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(keys, n);
  return cudaGetLastError();
}

// K6, one ring step of one rank: folds every pair into keys.
int drt_ring_nearest_step(const float* rays, int64_t n_rays, const int* excl,
                          const float* tris, int n_tris, int gid_base,
                          long long* keys, int rt, int chunk, int device,
                          void* stream) {
  const NearestFn fn = nearest_for(rt);
  RingArgs p;
  unsigned blocks;
  const cudaError_t err = fn == nullptr ? cudaErrorInvalidValue
                                        : step_args(rays, n_rays, excl, tris,
                                                    n_tris, gid_base, rt,
                                                    chunk, device, &p, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks > 0)
    fn<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, chunk,
                                                                   keys);
  return cudaGetLastError();
}

// K6, once per rank and query, after its last step: (out_t, out_i) from
// the keys.
int drt_ring_unpack_keys(const long long* keys, float* out_t, int* out_i,
                         int64_t n, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n > 0)
    ring_unpack_keys<<<elem_blocks(n), kElemThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(keys, out_t,
                                                            out_i, n);
  return cudaGetLastError();
}

// K7, one ring step of one rank: acc (n_rays,) int32 0/1 flags, 1 stored
// for every ray found hit.
int drt_ring_any_step(const float* rays, int64_t n_rays, const int* excl,
                      const float* tris, int n_tris, int gid_base, int* acc,
                      int rt, int chunk, int device, void* stream) {
  const AnyFn fn = any_for(rt);
  RingArgs p;
  unsigned blocks;
  const cudaError_t err = fn == nullptr ? cudaErrorInvalidValue
                                        : step_args(rays, n_rays, excl, tris,
                                                    n_tris, gid_base, rt,
                                                    chunk, device, &p, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks > 0)
    fn<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p, chunk,
                                                                   acc);
  return cudaGetLastError();
}

const char* drt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// Block-sparse ray-triangle traversal kernels for Hopper (sm_90a).
//
// What each function replaces (distributed_raytracer_tpu/ops/pallas/bsr_trace.py):
//   nearest_chunk_kernel<RPT, true>   <- _nearest_kernel (:356) with
//                                        _pair_math(shared_origin=True) (:217)
//                                        (K1, reached through bsr_nearest;
//                                        primary rays)
//   any_chunk_kernel<RPT, true>       <- _any_kernel (:411), shared origin (K2,
//                                        reached through bsr_any; all lights'
//                                        shadow rays in one launch)
//   nearest_chunk_kernel<RPT, false>  <- _nearest_kernel with
//                                        _pair_math(shared_origin=False) (K3n:
//                                        every nearest query of the bounced
//                                        frame, whose reflection rays each
//                                        have their own origin)
//   any_chunk_kernel<RPT, false>      <- _any_kernel, shared_origin=False (K3a:
//                                        per-ray-origin any hit; the renderer
//                                        has no caller for it, shadows reverse
//                                        to the light)
//   nearest_mxu_kernel<NT>            <- _nearest_mxu_kernel with _pair_math_mxu
//                                        (K4: primary rays under use_mxu=True)
//   any_mxu_kernel<NT>                <- _any_mxu_kernel (K5: every shadow
//                                        launch under use_mxu=True)
// K4/K5 are described at their definitions below.
//
// All walk a flat, tile-major work list of (ray tile of rt rays, triangle
// block of tb triangles) items made by ops/cull.py and evaluate the
// Baldwin-Weber test for every (ray, triangle) pair of each item. Triangle
// rows are 16 floats [nx ny nz w | kux kuy kuz w_u | kvx kvy kvz w_v | 0 0 0 0].
// Two origin forms, one kernel body each for nearest and any hit, chosen by
// the template flag kShared. With a shared origin (K1, K2) the rows are the
// pack_tris_origin layout: the launch's common ray origin is folded in,
// w = plane_d - n.o, w_u = ku.o + c_u, w_v = kv.o + c_v. With per-ray origins
// (K3n, K3a) they are the static pack_tris layout (w = plane_d, w_u = c_u,
// w_v = c_v) and each ray's origin is read from ray rows 0..2 and dotted in
// per pair.
//
// What bounds them on this card: the pair math (pair_math.cuh) is 21 FP32
// operations per (ray, triangle) pair with a shared origin (den 5, the
// division 1, u 7, v 7, u + v 1) and seven compares; per-ray origins add
// 18 (three origin dots and their folds). Against that, 48 bytes of
// triangle data are shared by all rt rays of the tile: a tb = 64 block is
// 3 KB (4 KB as staged, with its zero columns), re-read once per work item.
// So the kernels are bound by FP32 instruction throughput and the IEEE
// division, not by memory: one item is rt * tb = 32K pairs for 4 KB read.
//
// Numerics. Built without --use_fast_math: the validity test relies on IEEE
// division by a zero den (inf or NaN) and on NaN comparing false (a dead
// ray, scattered back as a zero direction, has den == 0 against every
// triangle). Built with -fmad=false: otherwise nvcc contracts
// nx*dx + ny*dy + nz*dz into fused multiply-adds, which round once instead
// of twice and would make t, u and v differ from the plain PyTorch version
// (and the JAX reference) in the last bit, flipping hit decisions on shared
// edges. With it, the pair math (pair_math.cuh) is the operation order
// of _pair_math (bsr_trace.py:236-248), rounded after every operation,
// and matches the plain version bit for bit. That matters most for the
// exclusion of the previous bounce's triangle, which keeps a reflection ray
// off its own surface only if both versions agree on every id.
//
// The C interface returns cudaGetLastError() after the launches; they are
// asynchronous on the caller's stream and allocate nothing (scratch comes
// from the wrapper).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "chunk_grid.cuh"  // kThreads, make_key, stage_async, ...
#include "pair_math.cuh"   // kEps, kOneEps, pair_math<kShared>

namespace {

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

// ---------------------------------------------------------------------------
// K1, K2, K3n, K3a: the CUDA-core kernels on an item-chunk grid.
//
// Measured on the H100 (PERF.md), the first design (one block of 128
// threads per ray tile, walking that tile's run of items) lasted as long as
// its longest tile's run: a block takes ~33 us per 32K-pair item with only
// ~2.5 warps per scheduler to hide the dependent FP32 chains and the
// division, and the runs are skewed (the 640x480 frame's K1 launch: 21
// items per tile on average, 42 at most; the bounced 1080p frame's bounce-1
// K3n launch: 63 on average, 342 at most). So the grid is over the work
// list instead:
//   - ceil(W / chunk) blocks of 128 threads; block b takes the live items
//     [b*chunk, min((b+1)*chunk, count)) (count read on the device; a block
//     past it exits). The wrapper passes chunk = 2 (ops/bsr_trace.py CHUNK,
//     chosen by sweeps on the card for both origin forms). A heavy tile is
//     spread over many blocks on many SMs, and every SM keeps several
//     blocks busy to the end.
//   - A block still holds one ray tile's rt rays at a time, rt / 128 per
//     thread, in registers (directions, exclusion ids and, per-ray form,
//     origins). The list is tile-major, so a chunk spans one tile or a
//     few: where the tile changes, the block flushes its rays' results and
//     loads the next tile's rays.
//   - Results merge across blocks exactly, in any order. Nearest: a 64-bit
//     atomicMin on the plain version's key (bits(t + 0.0) << 32) | id
//     (ops/bsr_trace.py _keys) in an (R,) scratch the wrapper allocates:
//     seed_keys writes init's keys, the chunks fold into them, unpack_keys
//     writes (out_t, out_i); three launches per call, so the result is the
//     plain version's bit for bit whatever the schedule (a hit at t = -0.0
//     comes back as +0.0, as the plain version's keys give it). A thread
//     first folds each of its rays over one item in registers (rows in
//     increasing id, so a strict < keeps the lowest id of a tie), merges
//     the item into the ray's key once, and issues one atomic per changed
//     ray per tile run. Any hit: out starts as a copy of init
//     (cudaMemcpyAsync), and a block stores 1 for each ray it found hit
//     (every writer writes the same 1); one copy and one launch per call.
//   - Tiles the work list does not name keep init (their keys or flags are
//     never touched).
//   - Staging is asynchronous: triangle blocks go into a two-slot ring in
//     shared memory as 16-byte cp.async copies, one commit group per item.
//     While item w is tested, item w+1's block is in flight; at the top of
//     each item a thread waits for its own copies and ONE __syncthreads
//     publishes everyone's and frees the other slot for the next copy.
//     cp.async rather than the 1-D TMA bulk copy: a 4 KB block is two
//     16-byte copies per thread, the one barrier per item is needed anyway
//     (slot reuse, and the any-hit vote below), and there is no mbarrier
//     phase to track; the copies cost nothing next to 32K pairs of math.
//   - Nearest reads its rays' current keys from the scratch when it loads
//     a tile: init, and whatever other blocks already merged. Keys only
//     fall, so starting from them is exact, and they give the front-to-back
//     skip (exit_every > 0) a bound at once: the block skips an item whose
//     conservative entry distance (ops/cull.py, from the tile's hull of
//     origins and directions in either form) exceeds every ray's best t by
//     more than 1e-4, with the bound refreshed every exit_every items
//     tested. Such an item can neither win nor tie.
//   - Any hit reads its rays' flags when it loads a tile (flags only go
//     from 0 to 1), folds the all-hit vote into the item's barrier
//     (__syncthreads_and: a tile whose rays are all hit skips its remaining
//     items), skips an item for a warp whose rays are all hit, and leaves
//     the row loop once they all are. exit_every has nothing left to do.
// The pair math is pair_math<kShared> (-fmad=false, IEEE division), so the
// four kernels equal bsr_nearest_ref / bsr_any_ref bit for bit.
//
// Where that leaves them (PERF.md): the 640x480 frame's K1 launch is
// 0.227 G pairs, 0.071 ms of FP32 operations at the 67 TFLOP/s peak; it
// takes ~0.38 ms, 19% of that. The inner loop issues ~43 instructions per
// pair with a shared origin (the 21 operations, 8 compares, ~10 for the
// IEEE division and its slow-path branch, the fold), so even at full issue
// it would take ~0.29 ms; it runs at ~3/4 of that rate. K2 is alike (17%).
// Per-ray origins add the 18 origin operations per pair to the same loop:
// ~65 instructions per pair, so K3n's bounce-1 launch of the bounced 1080p
// frame (2.9 G pairs, a 1.69 ms bound) takes ~6.2 ms, 27% of its bound, at
// ~90% of full issue; K3a alike (25%). The 64-bit atomics of the merge
// (5.7 M in that launch) cost nothing measurable next to the pair math.
// ---------------------------------------------------------------------------

constexpr int kElemThreads = 256;  // seed_keys, unpack_keys

// seed_keys and unpack_keys do the same work in both origin forms; each
// form has its own instantiation so that a profile books them to the query
// (K1 or K3n) that issued them.
template <bool kShared>
__global__ void seed_keys(const float* __restrict__ init_t,
                          const int* __restrict__ init_i,
                          long long* __restrict__ keys, int64_t n) {
  const int64_t r = (int64_t)blockIdx.x * kElemThreads + threadIdx.x;
  if (r < n) keys[r] = make_key(init_t[r], init_i[r]);
}

template <bool kShared>
__global__ void unpack_keys(const long long* __restrict__ keys,
                            float* __restrict__ out_t,
                            int* __restrict__ out_i, int64_t n) {
  const int64_t r = (int64_t)blockIdx.x * kElemThreads + threadIdx.x;
  if (r < n) split_key(keys[r], out_t + r, out_i + r);
}

// A block's chunk of live items [lo, hi); empty past count.
struct Chunk {
  int lo, hi;
  __device__ __forceinline__ Chunk(const WorkArgs& p, int chunk) {
    const int n = min(max(*p.count, 0), p.n_items);
    lo = min((int)blockIdx.x * chunk, n);
    hi = min(lo + chunk, n);
  }
};

// One thread's RPT rays of the block's current tile: directions, exclusion
// ids and, with per-ray origins (kShared false), origins. With a shared
// origin the origin is folded into the triangle rows; ox, oy, oz are then
// never loaded or read, and the compiler keeps no registers for them.
template <int RPT, bool kShared>
struct TileRays {
  float ox[RPT], oy[RPT], oz[RPT], dx[RPT], dy[RPT], dz[RPT];
  int ex[RPT];

  static __device__ __forceinline__ int64_t ray(int tile, int j) {
    return (int64_t)tile * (kThreads * RPT) + threadIdx.x + j * kThreads;
  }

  __device__ __forceinline__ void load(const WorkArgs& p, int tile) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int64_t r = ray(tile, j);
      if constexpr (!kShared) {
        ox[j] = p.rays[r];
        oy[j] = p.rays[p.n_rays + r];
        oz[j] = p.rays[2 * p.n_rays + r];
      }
      dx[j] = p.rays[3 * p.n_rays + r];
      dy[j] = p.rays[4 * p.n_rays + r];
      dz[j] = p.rays[5 * p.n_rays + r];
      ex[j] = p.excl[r];
    }
  }

  // Ray j against the triangle row (a, b, c): the Baldwin-Weber test
  // (pair_math.cuh), *t the pair's t. The caller tests the exclusion id
  // after it, as the shared-origin loops always did: with the test folded
  // into this helper, the any-hit loop compiled to more compares and ran
  // slower on the H100.
  __device__ __forceinline__ bool pair(const float4 a, const float4 b,
                                       const float4 c, int j,
                                       float* t) const {
    return pair_math<kShared>(a, b, c, kShared ? 0.0f : ox[j],
                              kShared ? 0.0f : oy[j], kShared ? 0.0f : oz[j],
                              dx[j], dy[j], dz[j], t);
  }
};

// Block-wide max of the rays' best t (a NaN seed counts as inf: it bounds
// nothing).
template <int RPT>
__device__ float block_max(const float (&bt)[RPT], float* warp_max) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < RPT; ++j) m = fmaxf(m, bt[j] == bt[j] ? bt[j] : INFINITY);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float b = warp_max[0];
#pragma unroll
  for (int k = 1; k < kThreads / 32; ++k) b = fmaxf(b, warp_max[k]);
  __syncthreads();  // warp_max is rewritten at the next refresh
  return b;
}

template <int RPT, bool kShared>
__global__ void __launch_bounds__(kThreads)
    nearest_chunk_kernel(const WorkArgs p, int chunk,
                         long long* __restrict__ keys) {
  extern __shared__ float4 ring[];  // two slots of tb * 4 float4
  __shared__ float warp_max[kThreads / 32];

  const Chunk c(p, chunk);
  if (c.lo == c.hi) return;
  const int slot4 = p.tb * 4;
  const int gid0 = *p.gid_base;
  stage_async(p.tris, p.block_ids[c.lo], p.tb, ring);

  TileRays<RPT, kShared> ray;
  float bt[RPT];  // the rays' keys as (t, id) halves
  int bi[RPT];
  unsigned changed = 0;  // bit j: ray j's key fell in this tile run
  int tile = -1;
  float bound = INFINITY;  // block-uniform
  int tested = 0;

  for (int w = c.lo; w < c.hi; ++w) {
    const int t = p.tile_ids[w];
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
      if (p.exit_every) {
        bound = block_max<RPT>(bt, warp_max);
        tested = 0;
      }
    }
    wait_staged();
    __syncthreads();  // item w's block is in; the other slot is free
    if (w + 1 < c.hi)
      stage_async(p.tris, p.block_ids[w + 1], p.tb,
                  ring + ((w + 1 - c.lo) & 1) * slot4);
    // Front-to-back skip: every ray's best hit is nearer than this block.
    if (p.exit_every && !(p.entry[w] <= bound + kExitSlack)) continue;
    const float4* tri_s = ring + ((w - c.lo) & 1) * slot4;
    const int g0 = gid0 + p.block_ids[w] * p.tb;
    // The item's (t, id) minimum per ray; a pair that misses counts as
    // (inf, id), so an item without a hit gives (inf, g0).
    float it[RPT];
    int ii[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      it[j] = INFINITY;
      ii[j] = g0;
    }
#pragma unroll 2
    for (int row = 0; row < p.tb; ++row) {
      const float4 a = tri_s[4 * row];
      const float4 b = tri_s[4 * row + 1];
      const float4 cc = tri_s[4 * row + 2];
      const int g = g0 + row;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        float tt;
        if (ray.pair(a, b, cc, j, &tt) && g != ray.ex[j] && tt < it[j]) {
          it[j] = tt;
          ii[j] = g;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const long long k = make_key(it[j], ii[j]);
      if (k < join_key(bt[j], bi[j])) {
        split_key(k, &bt[j], &bi[j]);
        changed |= 1u << j;
      }
    }
    if (p.exit_every && ++tested % p.exit_every == 0)
      bound = block_max<RPT>(bt, warp_max);
  }
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    if (changed >> j & 1u)
      atomicMin(keys + ray.ray(tile, j), join_key(bt[j], bi[j]));
}

template <int RPT, bool kShared>
__global__ void __launch_bounds__(kThreads)
    any_chunk_kernel(const WorkArgs p, int chunk, int* __restrict__ out) {
  extern __shared__ float4 ring[];  // two slots of tb * 4 float4

  const Chunk c(p, chunk);
  if (c.lo == c.hi) return;
  const int slot4 = p.tb * 4;
  const int gid0 = *p.gid_base;
  stage_async(p.tris, p.block_ids[c.lo], p.tb, ring);

  TileRays<RPT, kShared> ray;
  float tmax[RPT];
  int hit[RPT];
  unsigned found = 0;  // bit j: ray j found hit in this tile run
  int tile = -1;

  for (int w = c.lo; w < c.hi; ++w) {
    const int t = p.tile_ids[w];
    if (t != tile) {  // block-uniform
      if (tile >= 0) {
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          if (found >> j & 1u) out[ray.ray(tile, j)] = 1;
      }
      tile = t;
      ray.load(p, tile);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int64_t r = ray.ray(tile, j);
        tmax[j] = p.rays[6 * p.n_rays + r];
        hit[j] = __ldcg(out + r);  // init, or set by another block
      }
      found = 0;
    }
    wait_staged();
    int all = 1;
#pragma unroll
    for (int j = 0; j < RPT; ++j) all &= hit[j] != 0;
    // Item w's block is in, the other slot is free, and the vote: once
    // every ray of the tile is hit, its later items change nothing.
    const int tile_done = __syncthreads_and(all);
    if (w + 1 < c.hi)
      stage_async(p.tris, p.block_ids[w + 1], p.tb,
                  ring + ((w + 1 - c.lo) & 1) * slot4);
    if (tile_done || __all_sync(0xffffffffu, all)) continue;
    const float4* tri_s = ring + ((w - c.lo) & 1) * slot4;
    const int g0 = gid0 + p.block_ids[w] * p.tb;
#pragma unroll 2
    for (int row = 0; row < p.tb; ++row) {
      const float4 a = tri_s[4 * row];
      const float4 b = tri_s[4 * row + 1];
      const float4 cc = tri_s[4 * row + 2];
      const int g = g0 + row;
      int rest = 0;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        if (hit[j]) continue;  // an occluded ray stays occluded
        float tt;
        if (ray.pair(a, b, cc, j, &tt) && g != ray.ex[j] &&
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
    if (found >> j & 1u) out[ray.ray(tile, j)] = 1;
}

// Dynamic shared memory above the 48 KB default needs an opt-in.
template <typename Fn>
cudaError_t allow_smem(Fn fn, size_t bytes) {
  if (bytes <= 48 * 1024 - 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// ---------------------------------------------------------------------------
// K4 and K5: the direction dots on the tensor cores.
//
// The TPU kernels (_pair_math_mxu, bsr_trace.py:259-284) take the three
// direction dots of a shared-origin pair, den = n.d, kud = ku.d and
// kvd = kv.d, as ONE product A (3tb, 8) @ rays (8, rt) at HIGHEST
// precision: A stacks [n; ku; kv] per triangle block with xyz in columns
// 3:6 (pack_dirs), and the origin-dependent scalars (num, a_u, a_v) come
// from a (T, 8) side array (fold_origin_scal). Here the product runs on
// Hopper's tensor cores with warp-level mma.sync.m16n8k8 in TF32, whose K
// of 8 is exactly A's 8 columns. One TF32 pass keeps 10 mantissa bits and
// would corrupt hit tests, so every operand is split x = hi + lo (both
// TF32: hi = rna(x), lo = rna(x - hi)) and each dot is
// A_lo.B_hi + A_hi.B_lo + A_hi.B_hi accumulated in FP32 (3xTF32; the
// dropped A_lo.B_lo is ~2^-22 relative), the TPU's bf16x6 pass in another
// form. The dots are then within a few FP32 ulps of the CUDA-core K1/K2,
// not bit-equal, so K4/K5 are held to their plain versions under stated
// tolerances. B is the ray tile's d rows only (rows 3..5; the rest of the
// K dimension is zero), so the finite-big t_max row never enters.
//
// What bounds them: per (16 triangles x 8 rays) tile, 9 mma (3 matrices x 3
// passes) do the 15 multiply-adds per pair that K1 issues on the CUDA
// cores; the rest of the pair math (the division, two products with t,
// the bounds) stays there. So K4 trades ~half of K1's FP32 instructions
// for tensor-core work and operand splits, and is still bound by FP32
// issue and the IEEE division. Memory is negligible, as for K1.
//
// Layout, simple first. One block of 8 warps per ray tile of rt = 64 * NT
// rays; warp w owns NT 8-ray column tiles, so no reduction crosses warps.
// Per work item the block stages A's 3tb rows and the tb scalar rows in
// shared memory; each warp walks the triangle block 16 rows at a time:
// it loads the three A fragments (split hi/lo once, reused by its NT
// column tiles), and for each column tile issues 9 mma whose C fragments
// line up element for element: lane (g = lane>>2, q = lane&3) holds den,
// kud and kvd of triangle rows g and g+8 and ray columns 2q and 2q+1. The
// epilogue (t = num/den, u = a_u + t*kud, v = a_v + t*kvd, in
// _pair_math_mxu's order under -fmad=false) folds each pair into a running
// (t, id) minimum (any-hit: a flag) per lane and ray column. The 8 lanes
// sharing a column (xor 4, 8, 16) are folded at every early-exit refresh
// and once at the end; lanes with g == 0 write the result.
// ---------------------------------------------------------------------------

constexpr int kMxuWarps = 8;
constexpr int kMxuThreads = kMxuWarps * 32;
constexpr uint32_t kTf32Mask = 0xffffe000u;  // TF32 keeps 10 mantissa bits

// The K4/K5 launch: the A matrix rides WorkArgs::tris.
struct MxuArgs {
  WorkArgs w;
  const float4* scal;     // (S, 8) rows num a_u a_v 0...
  const int* ablock_ids;  // (W,) A block per item
};

// x rounded to TF32 (nearest, ties away), low bits cleared so the value
// the tensor core multiplies is exactly the one the split subtracts.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & kTf32Mask;
}

struct Tf32x2 {
  uint32_t hi, lo;
};

__device__ __forceinline__ Tf32x2 split_tf32(float x) {
  const uint32_t hi = tf32(x);
  return {hi, tf32(x - __uint_as_float(hi))};
}

// d += a (16x8, row) . b (8x8, col), TF32 in, FP32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16x8 tile of one dot, 3xTF32: small products first.
__device__ __forceinline__ void dot_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const Tf32x2 b0, const Tf32x2 b1) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  mma_tf32(d, a_lo, b0.hi, b1.hi);
  mma_tf32(d, a_hi, b0.lo, b1.lo);
  mma_tf32(d, a_hi, b0.hi, b1.hi);
}

// The A fragments of one 16-row slice of the staged [n; ku; kv] block: for
// matrix m, a[0] = (row g, col q), a[1] = (g+8, q), a[2] = (g, q+4),
// a[3] = (g+8, q+4), the m16n8k8 row-major A layout.
struct AFrags {
  uint32_t hi[3][4], lo[3][4];

  __device__ __forceinline__ void load(const float* dirs_s, int tb, int row0,
                                       int g, int q) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const float* r = dirs_s + (m * tb + row0 + g) * 8;
      const float v[4] = {r[q], r[64 + q], r[q + 4], r[64 + q + 4]};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const Tf32x2 s = split_tf32(v[k]);
        hi[m][k] = s.hi;
        lo[m][k] = s.lo;
      }
    }
  }
};

// Baldwin-Weber's epilogue for one pair from the dots (_pair_math_mxu's
// operation order).
__device__ __forceinline__ bool pair_mxu(float den, float kud, float kvd,
                                         float num, float au, float av,
                                         float* t_out) {
  const float t = num / den;
  const float u = au + t * kud;
  const float v = av + t * kvd;
  *t_out = t;
  const float uv = u + v;
  return (den != 0.0f) & (t >= 0.0f) & (u >= -kEps) & (u <= kOneEps) &
         (uv >= -kEps) & (uv <= kOneEps) & (v >= -kEps);
}

// The B fragments (rays' d rows) of column tile `col0` for lane (g, q):
// b0 holds K row q (row 3 = dx for q == 3), b1 K row q + 4 (dy for q == 0,
// dz for q == 1); the other K rows are zero.
__device__ __forceinline__ void load_b(const WorkArgs& p, int64_t col0, int g,
                                       int q, Tf32x2* b0, Tf32x2* b1) {
  const int64_t r = col0 + g;
  *b0 = split_tf32(q == 3 ? p.rays[3 * p.n_rays + r] : 0.0f);
  *b1 = split_tf32(q < 2 ? p.rays[(4 + q) * p.n_rays + r] : 0.0f);
}

// Stage item w's A block (3tb rows) and scalar block (tb rows).
__device__ __forceinline__ void stage_mxu(const MxuArgs& p, int w,
                                          float4* dirs_s, float4* scal_s) {
  const int tb = p.w.tb;
  const float4* a = p.w.tris + (int64_t)p.ablock_ids[w] * tb * 6;
  for (int k = threadIdx.x; k < tb * 6; k += kMxuThreads) dirs_s[k] = a[k];
  const float4* s = p.scal + (int64_t)p.w.block_ids[w] * tb * 2;
  for (int k = threadIdx.x; k < tb * 2; k += kMxuThreads) scal_s[k] = s[k];
  __syncthreads();
}

__device__ __forceinline__ void fold_min(float* t, int* i, float ot, int oi) {
  if (ot < *t || (ot == *t && oi < *i)) {
    *t = ot;
    *i = oi;
  }
}

// Lexicographic (t, id) minimum over the 8 lanes sharing a ray column.
__device__ __forceinline__ void fold_lanes_min(float* t, int* i) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    const float ot = __shfl_xor_sync(0xffffffffu, *t, off);
    const int oi = __shfl_xor_sync(0xffffffffu, *i, off);
    fold_min(t, i, ot, oi);
  }
}

// Any-hit flag (0/1) maximum over the 8 lanes sharing a ray column.
__device__ __forceinline__ void fold_lanes_max(int* hit) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1)
    *hit = max(*hit, __shfl_xor_sync(0xffffffffu, *hit, off));
}

// Warp vote: every ray of the warp's column tile (both of each lane's
// columns, all lanes) is hit.
__device__ __forceinline__ bool all_hit(const int (&hit)[2]) {
  return __all_sync(0xffffffffu, (hit[0] != 0) & (hit[1] != 0));
}

template <int NT>
__global__ void __launch_bounds__(kMxuThreads)
    nearest_mxu_kernel(const MxuArgs p, const float* __restrict__ init_t,
                       const int* __restrict__ init_i,
                       float* __restrict__ out_t, int* __restrict__ out_i) {
  constexpr int kRays = kMxuWarps * NT * 8;  // rt
  extern __shared__ float4 smem[];
  __shared__ int run[2];
  __shared__ int excl_s[kRays];
  __shared__ float warp_max[kMxuWarps];

  const int tb = p.w.tb;
  float4* dirs_s = smem;
  float4* scal_s = smem + tb * 6;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int64_t tile0 = (int64_t)blockIdx.x * kRays;
  const int local0 = warp * NT * 8;  // the warp's first ray in the tile

  for (int k = threadIdx.x; k < kRays; k += kMxuThreads)
    excl_s[k] = p.w.excl[tile0 + k];
  Tf32x2 b0[NT], b1[NT];
  float bt[NT][2];
  int bi[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    load_b(p.w, tile0 + local0 + j * 8, g, q, &b0[j], &b1[j]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int64_t r = tile0 + local0 + j * 8 + 2 * q + c;
      bt[j][c] = init_t[r];
      bi[j][c] = init_i[r];
    }
  }
  find_run(p.w, blockIdx.x, run);  // its __syncthreads covers excl_s
  const int lo = run[0], hi = run[1];
  const int gid0 = *p.w.gid_base;
  float bound = INFINITY;  // block-uniform
  int done = 0;

  for (int w = lo; w < hi; ++w) {
    if (p.w.exit_every && !(p.w.entry[w] <= bound + kExitSlack)) continue;
    stage_mxu(p, w, dirs_s, scal_s);
    const float* dirs_f = reinterpret_cast<const float*>(dirs_s);
    const float* scal_f = reinterpret_cast<const float*>(scal_s);
    const int g0 = gid0 + p.w.block_ids[w] * tb;
    for (int row0 = 0; row0 < tb; row0 += 16) {
      AFrags a;
      a.load(dirs_f, tb, row0, g, q);
      float num[2], au[2], av[2];
      int gid[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* s = scal_f + (row0 + g + 8 * h) * 8;
        num[h] = s[0];
        au[h] = s[1];
        av[h] = s[2];
        gid[h] = g0 + row0 + g + 8 * h;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float den[4], kud[4], kvd[4];
        dot_3xtf32(den, a.hi[0], a.lo[0], b0[j], b1[j]);
        dot_3xtf32(kud, a.hi[1], a.lo[1], b0[j], b1[j]);
        dot_3xtf32(kvd, a.hi[2], a.lo[2], b0[j], b1[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // C element e: row h = e>>1, col c
          const int h = e >> 1, c = e & 1;
          float t;
          const bool valid =
              pair_mxu(den[e], kud[e], kvd[e], num[h], au[h], av[h], &t) &&
              gid[h] != excl_s[local0 + j * 8 + 2 * q + c];
          fold_min(&bt[j][c], &bi[j][c], valid ? t : INFINITY, gid[h]);
        }
      }
    }
    __syncthreads();  // the staged block is overwritten by the next item
    if (p.w.exit_every && ++done % p.w.exit_every == 0) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          fold_lanes_min(&bt[j][c], &bi[j][c]);
          m = fmaxf(m, bt[j][c]);
        }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (lane == 0) warp_max[warp] = m;
      __syncthreads();
      bound = warp_max[0];
#pragma unroll
      for (int k = 1; k < kMxuWarps; ++k) bound = fmaxf(bound, warp_max[k]);
      __syncthreads();  // warp_max is rewritten at the next refresh
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      fold_lanes_min(&bt[j][c], &bi[j][c]);
      if (g == 0) {
        const int64_t r = tile0 + local0 + j * 8 + 2 * q + c;
        out_t[r] = bt[j][c];
        out_i[r] = bi[j][c];
      }
    }
}

template <int NT>
__global__ void __launch_bounds__(kMxuThreads)
    any_mxu_kernel(const MxuArgs p, const int* __restrict__ init,
                   int* __restrict__ out) {
  constexpr int kRays = kMxuWarps * NT * 8;
  extern __shared__ float4 smem[];
  __shared__ int run[2];
  __shared__ int excl_s[kRays];
  __shared__ float tmax_s[kRays];

  const int tb = p.w.tb;
  float4* dirs_s = smem;
  float4* scal_s = smem + tb * 6;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int64_t tile0 = (int64_t)blockIdx.x * kRays;
  const int local0 = warp * NT * 8;

  for (int k = threadIdx.x; k < kRays; k += kMxuThreads) {
    excl_s[k] = p.w.excl[tile0 + k];
    tmax_s[k] = p.w.rays[6 * p.w.n_rays + tile0 + k];
  }
  Tf32x2 b0[NT], b1[NT];
  int hit[NT][2];
  unsigned skip = 0;  // warp-uniform: bit j set once tile j is all hit
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    load_b(p.w, tile0 + local0 + j * 8, g, q, &b0[j], &b1[j]);
#pragma unroll
    for (int c = 0; c < 2; ++c)
      hit[j][c] = init[tile0 + local0 + j * 8 + 2 * q + c];
    if (all_hit(hit[j])) skip |= 1u << j;
  }
  find_run(p.w, blockIdx.x, run);
  const int lo = run[0], hi = run[1];
  const int gid0 = *p.w.gid_base;
  int done = 0;

  for (int w = lo; w < hi; ++w) {
    stage_mxu(p, w, dirs_s, scal_s);
    const float* dirs_f = reinterpret_cast<const float*>(dirs_s);
    const float* scal_f = reinterpret_cast<const float*>(scal_s);
    const int g0 = gid0 + p.w.block_ids[w] * tb;
    for (int row0 = 0; row0 < tb; row0 += 16) {
      AFrags a;
      a.load(dirs_f, tb, row0, g, q);
      float num[2], au[2], av[2];
      int gid[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* s = scal_f + (row0 + g + 8 * h) * 8;
        num[h] = s[0];
        au[h] = s[1];
        av[h] = s[2];
        gid[h] = g0 + row0 + g + 8 * h;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (skip >> j & 1u) continue;  // every ray of the column tile is hit
        float den[4], kud[4], kvd[4];
        dot_3xtf32(den, a.hi[0], a.lo[0], b0[j], b1[j]);
        dot_3xtf32(kud, a.hi[1], a.lo[1], b0[j], b1[j]);
        dot_3xtf32(kvd, a.hi[2], a.lo[2], b0[j], b1[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, c = e & 1;
          const int k = local0 + j * 8 + 2 * q + c;
          float t;
          if (pair_mxu(den[e], kud[e], kvd[e], num[h], au[h], av[h], &t) &&
              gid[h] != excl_s[k] && t <= tmax_s[k])
            hit[j][c] = 1;
        }
      }
    }
    __syncthreads();  // the staged block is overwritten by the next item
    if (p.w.exit_every && ++done % p.w.exit_every == 0) {
      int all = 1;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          fold_lanes_max(&hit[j][c]);
          all &= hit[j][c] != 0;
        }
        if (all_hit(hit[j])) skip |= 1u << j;
      }
      if (__syncthreads_and(all)) break;  // every ray of the tile is hit
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      fold_lanes_max(&hit[j][c]);
      if (g == 0) out[tile0 + local0 + j * 8 + 2 * q + c] = hit[j][c];
    }
}

// Rays per thread (RPT = rt / 128) and the origin form are template
// parameters of K1/K2/K3n/K3a; these pick the instantiation for a launch.
using NearestChunkFn = void (*)(WorkArgs, int, long long*);
using AnyChunkFn = void (*)(WorkArgs, int, int*);

template <bool kShared>
NearestChunkFn nearest_chunk_for(int rt) {
  switch (rt) {
    case 128: return nearest_chunk_kernel<1, kShared>;
    case 256: return nearest_chunk_kernel<2, kShared>;
    case 512: return nearest_chunk_kernel<4, kShared>;
    case 1024: return nearest_chunk_kernel<8, kShared>;
    default: return nullptr;
  }
}

template <bool kShared>
AnyChunkFn any_chunk_for(int rt) {
  switch (rt) {
    case 128: return any_chunk_kernel<1, kShared>;
    case 256: return any_chunk_kernel<2, kShared>;
    case 512: return any_chunk_kernel<4, kShared>;
    case 1024: return any_chunk_kernel<8, kShared>;
    default: return nullptr;
  }
}

using NearestMxuFn = void (*)(MxuArgs, const float*, const int*, float*,
                              int*);
using AnyMxuFn = void (*)(MxuArgs, const int*, int*);

// Column tiles per warp: NT = rt / (8 warps * 8 rays).
NearestMxuFn nearest_mxu_for(int rt) {
  switch (rt) {
    case 128: return nearest_mxu_kernel<2>;
    case 256: return nearest_mxu_kernel<4>;
    case 512: return nearest_mxu_kernel<8>;
    case 1024: return nearest_mxu_kernel<16>;
    default: return nullptr;
  }
}

AnyMxuFn any_mxu_for(int rt) {
  switch (rt) {
    case 128: return any_mxu_kernel<2>;
    case 256: return any_mxu_kernel<4>;
    case 512: return any_mxu_kernel<8>;
    case 1024: return any_mxu_kernel<16>;
    default: return nullptr;
  }
}

// Dynamic shared memory of a K4/K5 launch: A's 3tb rows and the tb scalar
// rows, 8 floats each; above the 48 KB default (tb > 352) the kernel must
// opt in.
template <typename Fn>
cudaError_t mxu_smem(Fn fn, int tb, size_t* smem) {
  *smem = (size_t)tb * 8 * 8 * sizeof(float);
  if (*smem <= 48 * 1024 - 8 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

WorkArgs work_args(const float* rays, int64_t n_rays, const int* excl,
                   const float* tris, const int* tile_ids,
                   const int* block_ids, const float* entry, const int* count,
                   int n_items, const int* gid_base, int tb, int exit_every) {
  return WorkArgs{rays, n_rays, excl, reinterpret_cast<const float4*>(tris),
                  tile_ids, block_ids, entry, count, n_items, gid_base, tb,
                  exit_every};
}

// The nearest query in one origin form: seed_keys, the chunks (when the
// list has slots), unpack_keys.
template <bool kShared>
cudaError_t nearest_chunks(const WorkArgs& p, const float* init_t,
                           const int* init_i, long long* keys, float* out_t,
                           int* out_i, int rt, int chunk, cudaStream_t s) {
  const NearestChunkFn fn = nearest_chunk_for<kShared>(rt);
  if (fn == nullptr || chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)p.tb * 16 * sizeof(float);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  const unsigned eg =
      (unsigned)((p.n_rays + kElemThreads - 1) / kElemThreads);
  seed_keys<kShared><<<eg, kElemThreads, 0, s>>>(init_t, init_i, keys,
                                                 p.n_rays);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.n_items > 0) {
    fn<<<(p.n_items + chunk - 1) / chunk, kThreads, smem, s>>>(p, chunk,
                                                               keys);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  unpack_keys<kShared><<<eg, kElemThreads, 0, s>>>(keys, out_t, out_i,
                                                   p.n_rays);
  return cudaGetLastError();
}

// The any-hit query in one origin form: a device-to-device copy of init
// into out, then the chunks (when the list has slots).
template <bool kShared>
cudaError_t any_chunks(const WorkArgs& p, const int* init, int* out, int rt,
                       int chunk, cudaStream_t s) {
  const AnyChunkFn fn = any_chunk_for<kShared>(rt);
  if (fn == nullptr || chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)p.tb * 16 * sizeof(float);
  cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  err = cudaMemcpyAsync(out, init, p.n_rays * sizeof(int),
                        cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return err;
  if (p.n_items > 0)
    fn<<<(p.n_items + chunk - 1) / chunk, kThreads, smem, s>>>(p, chunk, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rt must be 128, 256, 512 or 1024. The Python wrapper (ops/bsr_trace.py)
// checks every shape, dtype, device, alignment and contiguity before
// calling.

// K1 (shared != 0: pack_tris_origin rows) and K3n (shared == 0: static
// pack_tris rows, per-ray origins): the nearest hit on the chunk grid,
// `chunk` >= 1 items per block; keys is an (n_rays,) int64 scratch. Three
// launches: seed_keys, the chunks (when the list has slots), unpack_keys.
int drt_bsr_nearest(const float* rays, int64_t n_rays, const int* excl,
                    const float* tris, const int* tile_ids,
                    const int* block_ids, const float* entry, const int* count,
                    int n_items, const float* init_t, const int* init_i,
                    const int* gid_base, long long* keys, float* out_t,
                    int* out_i, int rt, int tb, int exit_every, int chunk,
                    int shared, void* stream) {
  const WorkArgs p = work_args(rays, n_rays, excl, tris, tile_ids, block_ids,
                               entry, count, n_items, gid_base, tb,
                               exit_every);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return shared ? nearest_chunks<true>(p, init_t, init_i, keys, out_t, out_i,
                                       rt, chunk, s)
                : nearest_chunks<false>(p, init_t, init_i, keys, out_t, out_i,
                                        rt, chunk, s);
}

// K2 (shared != 0) and K3a (shared == 0): the any hit on the chunk grid.
// One device-to-device copy of init into out, then the chunks (when the
// list has slots).
int drt_bsr_any(const float* rays, int64_t n_rays, const int* excl,
                const float* tris, const int* tile_ids, const int* block_ids,
                const int* count, int n_items, const int* init,
                const int* gid_base, int* out, int rt, int tb, int chunk,
                int shared, void* stream) {
  const WorkArgs p = work_args(rays, n_rays, excl, tris, tile_ids, block_ids,
                               nullptr, count, n_items, gid_base, tb, 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return shared ? any_chunks<true>(p, init, out, rt, chunk, s)
                : any_chunks<false>(p, init, out, rt, chunk, s);
}

// The tensor-core forms (K4, K5): dirs is pack_dirs's (3T, 8) A, indexed
// by ablock_ids; scal the (S, 8) fold_origin_scal rows, indexed (with the
// global ids) by block_ids. tb must be a multiple of 16.
int drt_bsr_nearest_mxu(const float* rays, int64_t n_rays, const int* excl,
                        const float* dirs, const float* scal,
                        const int* tile_ids, const int* block_ids,
                        const int* ablock_ids, const float* entry,
                        const int* count, int n_items, const float* init_t,
                        const int* init_i, const int* gid_base, float* out_t,
                        int* out_i, int rt, int tb, int exit_every,
                        void* stream) {
  const NearestMxuFn fn = nearest_mxu_for(rt);
  if (fn == nullptr || tb % 16) return cudaErrorInvalidValue;
  size_t smem;
  const cudaError_t err = mxu_smem(fn, tb, &smem);
  if (err != cudaSuccess) return err;
  const MxuArgs p{work_args(rays, n_rays, excl, dirs, tile_ids, block_ids,
                            entry, count, n_items, gid_base, tb, exit_every),
                  reinterpret_cast<const float4*>(scal), ablock_ids};
  fn<<<(int)(n_rays / rt), kMxuThreads, smem,
       static_cast<cudaStream_t>(stream)>>>(p, init_t, init_i, out_t, out_i);
  return cudaGetLastError();
}

int drt_bsr_any_mxu(const float* rays, int64_t n_rays, const int* excl,
                    const float* dirs, const float* scal, const int* tile_ids,
                    const int* block_ids, const int* ablock_ids,
                    const int* count, int n_items, const int* init,
                    const int* gid_base, int* out, int rt, int tb,
                    int exit_every, void* stream) {
  const AnyMxuFn fn = any_mxu_for(rt);
  if (fn == nullptr || tb % 16) return cudaErrorInvalidValue;
  size_t smem;
  const cudaError_t err = mxu_smem(fn, tb, &smem);
  if (err != cudaSuccess) return err;
  const MxuArgs p{work_args(rays, n_rays, excl, dirs, tile_ids, block_ids,
                            nullptr, count, n_items, gid_base, tb, exit_every),
                  reinterpret_cast<const float4*>(scal), ablock_ids};
  fn<<<(int)(n_rays / rt), kMxuThreads, smem,
       static_cast<cudaStream_t>(stream)>>>(p, init, out);
  return cudaGetLastError();
}

const char* drt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

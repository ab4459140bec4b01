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
//   nearest_mxu_chunk_kernel<NT, W>   <- _nearest_mxu_kernel with
//                                        _pair_math_mxu (K4: primary rays
//                                        under use_mxu=True)
//   any_mxu_chunk_kernel<NT, W>       <- _any_mxu_kernel (K5: every shadow
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

// seed_keys and unpack_keys do the same work in every triangle form; each
// form has its own instantiation so that a profile books them to the query
// (K1, K3n or, with kMxu, K4) that issued them.
template <bool kShared, bool kMxu = false>
__global__ void seed_keys(const float* __restrict__ init_t,
                          const int* __restrict__ init_i,
                          long long* __restrict__ keys, int64_t n) {
  const int64_t r = (int64_t)blockIdx.x * kElemThreads + threadIdx.x;
  if (r < n) keys[r] = make_key(init_t[r], init_i[r]);
}

template <bool kShared, bool kMxu = false>
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

// ---------------------------------------------------------------------------
// K4 and K5: the direction dots on the tensor cores, on the item-chunk grid.
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
// the bounds, the exclusion, the fold) stays there. The tensor pipe is far
// from its limit (0.07 issued instructions per pair), so FP32 issue, the
// IEEE division and the latency of the mma chains bound them. Memory is
// negligible.
//
// The first design ran one block per ray tile through the tile's whole run
// of items and lasted as long as the longest run, as K1 did before its
// chunk grid. Now the grid is K1/K2's (see above):
//   - ceil(W / chunk) blocks of WARPS warps; block b takes the live items
//     [b*chunk, min((b+1)*chunk, count)) (count read on the device), one
//     ray tile of rt = WARPS * NT * 8 rays at a time. Warp w owns NT 8-ray
//     column tiles of it (NT = 8 at rt 512 and 1024, rt / 64 below), so no
//     pair crosses warps.
//   - Where the chunk enters a tile, the block writes the tile's rays into
//     shared memory: the d rows split to TF32 hi/lo once, as a table of
//     each ray's B fragment per lane class in the register order the mma
//     reads (no moves between load and mma), the exclusion ids, and K4's
//     current keys or K5's t_max.
//   - Each item's A block (ablock_ids[w], 3tb rows of 8 floats) and scalar
//     block (block_ids[w], tb rows) go into a two-slot ring as 16-byte
//     cp.async copies, one commit group per item (stage_async with two
//     sources: the all-lights shadow launch indexes the one A and the
//     stacked per-light scalars apart). While item w is tested, item w+1
//     is in flight; one barrier per item publishes the copies and frees the
//     other slot.
//   - The block splits the item's A to TF32 hi/lo once, into fragments in
//     shared memory (64 rows at a time, one more barrier each): cvt.rna.tf32
//     is several instructions on this card, and each warp splitting all of
//     A itself cost ~3.5 instructions per pair. Per 16-row slice and column
//     tile a warp reads the three fragments anew (an opaque zero in the
//     index keeps the compiler from holding all 24 registers of them across
//     the tile loop) and issues 9 mma, whose C fragments line up element
//     for element: lane (g = lane>>2, q = lane&3) holds den, kud and kvd of
//     triangle rows g and g+8 and ray columns 2q and 2q+1. The epilogue is
//     _pair_math_mxu's order under -fmad=false (pair_mxu).
//   - K4 folds each pair into a per-lane (t, row) minimum over the item with
//     a strict < (a lane meets its rows in increasing id, so a tie keeps the
//     lowest), from (inf, the item's first id), as the plain version counts
//     a miss as (inf, id); the rows of a column tile's two columns share a
//     register as 16-bit halves. After the item the 8 lanes sharing a ray
//     column fold their keys (bits(t + 0.0) << 32 | id) once,
//     reduce-scattered so that each lane ends with its share of the columns
//     and merges them into the tile's best keys in shared memory, and where
//     the chunk leaves the tile the block issues one 64-bit atomicMin per
//     ray whose key fell: seed_keys, the chunks, unpack_keys, as K1 (their
//     <true, true> instantiations, so a profile books them to K4). The keys
//     read at the tile's load (init, and whatever other blocks merged) give
//     the front-to-back skip (exit_every > 0) its bound at once, refreshed
//     every exit_every items tested: K1's exact rule.
//   - K5 keeps its rays' flags as a bit mask per lane (bit 2j + c), read
//     from out when the tile is loaded (init, or set by another block) and
//     ORed across the 8 lanes of a column after every slice. A warp skips a
//     column tile whose rays are all hit and the rest of the item once all
//     its rays are (it still meets the block's barriers); the block folds
//     its all-hit vote into the item barrier (__syncthreads_and) and skips
//     the tile's remaining items. Where the chunk leaves the tile, lane
//     g == 0 stores 1 for each ray it found hit; out starts as a copy of
//     init (cudaMemcpyAsync).
//   - Tiles the work list does not name keep init.
// Every pair's t and validity are the first design's (the same split, the
// same three mma per dot in the same order, the same epilogue), and the
// fold and the merge are order-free, so the outputs are its outputs (a
// winning t of -0.0 comes back as +0.0 through the key, as in the plain
// version).
//
// Where that leaves them (PERF.md, 640x480 launches): K5 runs below K2 on
// the same work, and further below on the bounced frame's heavy shadow
// launches; K4 stays above K1: its row loop is ~35 instructions per pair
// against K1's ~47, but it issues at about half of full rate against K1's
// ~3/4 (16 warps per SM at 124 registers; asking for more blocks spills).
// ---------------------------------------------------------------------------

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

// One 16x8 tile of one dot, 3xTF32, small products first: b holds the B
// fragment's TF32 halves as {b0.hi, b1.hi, b0.lo, b1.lo}.
__device__ __forceinline__ void dot_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint4 b) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
  mma_tf32(d, a_lo, b.x, b.y);
  mma_tf32(d, a_hi, b.z, b.w);
  mma_tf32(d, a_hi, b.x, b.y);
}

// Rows of A split per group, and the fragments' shared memory: per 16-row
// slice, matrix and lane, two uint4 (hi, lo).
constexpr int kSplitRows = 64;
constexpr int kSplitFrags = kSplitRows / 16 * 3 * 32;

// Splits A rows [row_lo, row_lo + rows) of the staged [n; ku; kv] block
// (rows a multiple of 16, at most kSplitRows) into TF32 hi/lo fragments in
// the m16n8k8 row-major A layout: for slice, matrix m and lane (g, q),
// af[(slice * 3 + m) * 64 + lane] holds the hi halves of m's (row g, col
// q), (g+8, q), (g, q+4), (g+8, q+4), and 32 entries on, the lo halves
// (a warp's 16-byte loads of one half are contiguous). All threads of the
// block split; every warp then reads its fragments with two 16-byte loads
// per matrix instead of splitting all of A itself.
template <int kBlock>
__device__ __forceinline__ void split_a(const float* dirs_s, int tb,
                                        int row_lo, int rows, uint4* af) {
  const int n = rows / 16 * 3 * 32;
  for (int f = threadIdx.x; f < n; f += kBlock) {
    const int lane = f & 31, m = (f >> 5) % 3, slice = (f >> 5) / 3;
    const int g = lane >> 2, q = lane & 3;
    const float* r = dirs_s + (m * tb + row_lo + slice * 16 + g) * 8;
    const Tf32x2 s0 = split_tf32(r[q]), s1 = split_tf32(r[64 + q]),
                 s2 = split_tf32(r[q + 4]), s3 = split_tf32(r[64 + q + 4]);
    const int at = (f >> 5) * 64 + lane;  // his, then los, per 32 lanes
    af[at] = make_uint4(s0.hi, s1.hi, s2.hi, s3.hi);
    af[at + 32] = make_uint4(s0.lo, s1.lo, s2.lo, s3.lo);
  }
}

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

// A K4/K5 block for rt = WARPS * NT * 8 rays, and its dynamic shared
// memory, in order: the ring's two slots (A's 6tb float4, then the
// scalars' 2tb), the split A fragments of kSplitRows rows, the B table,
// the exclusion ids, then K4's best keys and changed flags or K5's t_max.
// The B table holds each ray's B fragment per lane class as uint4
// {b0.hi, b1.hi, b0.lo, b1.lo} (the register pairs the mma reads): q = 0
// (b1 = dy), q = 1 (b1 = dz), q = 3 (b0 = dx); lanes q = 2 read the zero
// entry after the table.
template <int NT, int WARPS>
struct MxuTile {
  static constexpr int kBlock = WARPS * 32;
  static constexpr int kRays = WARPS * NT * 8;
  float4* ring;  // the other regions are computed from it and tb
  int tb;

  static size_t bytes(int tb, bool nearest) {
    return (size_t)tb * 16 * sizeof(float4) +
           (size_t)(2 * kSplitFrags + 3 * kRays + 1) * sizeof(uint4) +
           (size_t)kRays * (sizeof(int) + (nearest ? sizeof(long long) + 1
                                                   : sizeof(float)));
  }

  __device__ __forceinline__ MxuTile(float4* smem, int tb_)
      : ring(smem), tb(tb_) {}
  __device__ __forceinline__ uint4* af() const {
    return reinterpret_cast<uint4*>(ring + 16 * tb);
  }
  __device__ __forceinline__ uint4* bt() const {
    return af() + 2 * kSplitFrags;
  }
  __device__ __forceinline__ int* ex() const {
    return reinterpret_cast<int*>(bt() + 3 * kRays + 1);
  }
  __device__ __forceinline__ long long* best() const {
    return reinterpret_cast<long long*>(ex() + kRays);
  }
  __device__ __forceinline__ unsigned char* changed() const {
    return reinterpret_cast<unsigned char*>(best() + kRays);
  }
  __device__ __forceinline__ float* tmax() const {
    return reinterpret_cast<float*>(ex() + kRays);
  }

  // The tile's rays from global memory: the B table and exclusion ids.
  __device__ __forceinline__ void load_rays(const WorkArgs& p,
                                            int64_t tile0) const {
    if (threadIdx.x == 0) bt()[3 * kRays] = make_uint4(0u, 0u, 0u, 0u);
    for (int k = threadIdx.x; k < kRays; k += kBlock) {
      const int64_t r = tile0 + k;
      const Tf32x2 dx = split_tf32(p.rays[3 * p.n_rays + r]);
      const Tf32x2 dy = split_tf32(p.rays[4 * p.n_rays + r]);
      const Tf32x2 dz = split_tf32(p.rays[5 * p.n_rays + r]);
      bt()[3 * k] = make_uint4(0u, dy.hi, 0u, dy.lo);
      bt()[3 * k + 1] = make_uint4(0u, dz.hi, 0u, dz.lo);
      bt()[3 * k + 2] = make_uint4(dx.hi, 0u, dx.lo, 0u);
      ex()[k] = p.excl[r];
    }
  }

  // Lane (g, q)'s B entry of its warp's first column tile, and the stride
  // to the next column tile (0 for the zero entry).
  __device__ __forceinline__ const uint4* b_entry(int local0, int g, int q,
                                                  int* stride) const {
    *stride = q == 2 ? 0 : 3 * 8;
    return q == 2 ? bt() + 3 * kRays
                  : bt() + 3 * (local0 + g) + (q == 3 ? 2 : q);
  }
};

// Stage item w's A block (3tb rows) and scalar block (tb rows) into a ring
// slot as one commit group.
template <int kBlock>
__device__ __forceinline__ void stage_mxu(const MxuArgs& p, int w,
                                          float4* slot) {
  const int tb = p.w.tb;
  stage_async<kBlock>(p.w.tris + (int64_t)p.ablock_ids[w] * tb * 6, tb * 6,
                      slot, p.scal + (int64_t)p.w.block_ids[w] * tb * 2,
                      tb * 2, slot + tb * 6);
}

// One lane's per-slice inputs besides its A fragments: the scalars and
// global ids of its triangle rows g and g + 8.
struct RowScal {
  float num[2], au[2], av[2];
  int gid[2];

  __device__ __forceinline__ void load(const float* scal_s, int row0, int g,
                                       int g0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* s = scal_s + (row0 + g + 8 * h) * 8;
      num[h] = s[0];
      au[h] = s[1];
      av[h] = s[2];
      gid[h] = g0 + row0 + g + 8 * h;
    }
  }
};

// A zero the compiler cannot see through: an index offset that keeps
// loads of the same address in different column tiles apart.
__device__ __forceinline__ int opaque_zero() {
  int z;
  asm volatile("mov.u32 %0, 0;" : "=r"(z));
  return z;
}

// The 9 mma of one column tile: its B entry b against the slice's A
// fragments, read matrix by matrix from the split fragments af_slice
// (af + slice * 192) at lane + z (z an opaque zero, so that the
// fragments are read anew for each column tile instead of held: 24
// registers fewer for the tile's minima).
__device__ __forceinline__ void dot_af(float (&d)[4], const uint4* af_m,
                                       int at, const uint4 b) {
  const uint4 h = af_m[at], l = af_m[32 + at];
  const uint32_t hi[4] = {h.x, h.y, h.z, h.w};
  const uint32_t lo[4] = {l.x, l.y, l.z, l.w};
  dot_3xtf32(d, hi, lo, b);
}

__device__ __forceinline__ void dots_mxu(const uint4* af_slice, int at,
                                         const uint4 b, float (&den)[4],
                                         float (&kud)[4], float (&kvd)[4]) {
  dot_af(den, af_slice, at, b);
  dot_af(kud, af_slice + 64, at, b);
  dot_af(kvd, af_slice + 128, at, b);
}

// The (t, id) keys of a lane's NT x 2 item minima (t, and the row in the
// item of both columns of a tile as 16-bit halves), folded over the 8 lanes
// sharing its ray columns (lane bits 2-4) by reduce-scatter: each round
// halves the keys a lane holds, sending the half its partner keeps, so
// the shuffles of a round are independent and no lane idles; the first
// round makes its keys as it sends them, so they never all live at once.
// On return the lane holds in k[0, max(NT / 4, 1)) the folded keys of the
// flat columns (2j + c) *m, *m + 1, ...; it returns whether it owns them
// (with NT < 4 the lanes of the last round hold copies, and one owns).
template <int NT>
__device__ __forceinline__ bool fold_item_keys(const float (&it)[NT][2],
                                               const uint32_t (&rows2)[NT],
                                               int g0, int lane,
                                               long long (&k)[NT], int* m) {
  // Flat column c's key: its t and id g0 + its row (rows2's half c & 1).
  auto key = [&](int c) {
    return make_key(it[c >> 1][c & 1],
                    g0 + (int)(c & 1 ? rows2[c >> 1] >> 16
                                     : rows2[c >> 1] & 0xffffu));
  };
  bool up = lane & 16;
#pragma unroll
  for (int i = 0; i < NT; ++i) {  // flat columns i and i + NT
    const long long a = key(i), b = key(i + NT);
    const long long o = __shfl_xor_sync(0xffffffffu, up ? a : b, 16);
    const long long keep = up ? b : a;
    k[i] = o < keep ? o : keep;
  }
  int base = up ? NT : 0;
  bool owner = true;
#pragma unroll
  for (int r = 1; r < 3; ++r) {
    const int off = 16 >> r;
    const int live = NT >> (r - 1);  // compile-time once unrolled
    up = lane & off;
    if (live > 1) {
#pragma unroll
      for (int i = 0; i < live / 2; ++i) {
        const long long send = up ? k[i] : k[i + live / 2];
        const long long keep = up ? k[i + live / 2] : k[i];
        const long long o = __shfl_xor_sync(0xffffffffu, send, off);
        k[i] = o < keep ? o : keep;
      }
      base += up ? live / 2 : 0;
    } else {
      const long long o = __shfl_xor_sync(0xffffffffu, k[0], off);
      k[0] = o < k[0] ? o : k[0];
      owner = owner && !up;
    }
  }
  *m = base;
  return owner;
}

// Block-wide max of the tile's best t (the keys' high halves; a NaN counts
// as inf). The caller has synchronized since the keys were last written.
template <int NT, int WARPS>
__device__ float best_max(const MxuTile<NT, WARPS>& s, float* warp_max) {
  float m = -INFINITY;
  for (int k = threadIdx.x; k < MxuTile<NT, WARPS>::kRays;
       k += MxuTile<NT, WARPS>::kBlock) {
    float t;
    int i;
    split_key(s.best()[k], &t, &i);
    m = fmaxf(m, t == t ? t : INFINITY);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  float b = warp_max[0];
#pragma unroll
  for (int k = 1; k < WARPS; ++k) b = fmaxf(b, warp_max[k]);
  __syncthreads();  // warp_max is rewritten at the next refresh
  return b;
}

template <int NT, int WARPS, int MINB>
__global__ void __launch_bounds__(WARPS * 32, MINB)
    nearest_mxu_chunk_kernel(const MxuArgs p, int chunk,
                             long long* __restrict__ keys) {
  using Tile = MxuTile<NT, WARPS>;
  constexpr int kRays = Tile::kRays, kBlock = Tile::kBlock;
  extern __shared__ float4 smem[];
  __shared__ float warp_max[WARPS];

  const Chunk c(p.w, chunk);
  if (c.lo == c.hi) return;
  const int tb = p.w.tb;
  const Tile s(smem, tb);
  const int slot4 = 8 * tb;
  stage_mxu<kBlock>(p, c.lo, s.ring);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int local0 = warp * NT * 8;  // the warp's first ray in the tile
  const int gid0 = *p.w.gid_base;
  int tile = -1;
  float bound = INFINITY;  // block-uniform
  int tested = 0;

  for (int w = c.lo; w < c.hi; ++w) {
    const int t = p.w.tile_ids[w];
    const bool fresh = t != tile;  // block-uniform
    if (fresh) {
      if (tile >= 0) {
        __syncthreads();  // every warp is done with the tile
        for (int k = threadIdx.x; k < kRays; k += kBlock)
          if (s.changed()[k])
            atomicMin(keys + (int64_t)tile * kRays + k, s.best()[k]);
      }
      tile = t;
      s.load_rays(p.w, (int64_t)tile * kRays);
      for (int k = threadIdx.x; k < kRays; k += kBlock) {
        s.best()[k] = __ldcg(keys + (int64_t)tile * kRays + k);
        s.changed()[k] = 0;
      }
    }
    wait_staged();
    __syncthreads();  // item w's blocks and the tile's rays are in
    if (fresh && p.w.exit_every) {
      bound = best_max(s, warp_max);
      tested = 0;
    }
    if (w + 1 < c.hi)
      stage_mxu<kBlock>(p, w + 1, s.ring + ((w + 1 - c.lo) & 1) * slot4);
    // Front-to-back skip: every ray's best hit is nearer than this block.
    if (p.w.exit_every && !(p.w.entry[w] <= bound + kExitSlack)) continue;
    const float* dirs_f =
        reinterpret_cast<const float*>(s.ring + ((w - c.lo) & 1) * slot4);
    const float* scal_f = dirs_f + 24 * tb;
    const int g0 = gid0 + p.w.block_ids[w] * tb;
    // The lane's item minima: t per column, and the row in the item (the
    // id less g0) of both columns of a tile packed as 16-bit halves.
    float it[NT][2];
    uint32_t rows2[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      it[j][0] = it[j][1] = INFINITY;
      rows2[j] = 0u;  // a miss counts as (inf, g0)
    }
    for (int lo = 0; lo < tb; lo += kSplitRows) {
      const int rows = min(kSplitRows, tb - lo);
      if (lo) __syncthreads();  // every warp is done with the fragments
      split_a<kBlock>(dirs_f, tb, lo, rows, s.af());
      __syncthreads();
      int b_stride;
      const uint4* b_lane = s.b_entry(local0, g, q, &b_stride);
      for (int slice = 0; slice < rows / 16; ++slice) {
        const int row0 = lo + slice * 16;
        const uint4* af_slice = s.af() + slice * 192;
        RowScal rs;
        rs.load(scal_f, row0, g, g0);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float den[4], kud[4], kvd[4];
          dots_mxu(af_slice, lane + opaque_zero(), b_lane[j * b_stride], den,
                   kud, kvd);
          const int2 e2 = *reinterpret_cast<const int2*>(
              s.ex() + local0 + j * 8 + 2 * q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {  // C element e: row h = e>>1, col cc
            const int h = e >> 1, cc = e & 1;
            float tt;
            if (pair_mxu(den[e], kud[e], kvd[e], rs.num[h], rs.au[h],
                         rs.av[h], &tt) &&
                rs.gid[h] != (cc ? e2.y : e2.x) && tt < it[j][cc]) {
              it[j][cc] = tt;
              rows2[j] = __byte_perm(rows2[j], row0 + g + 8 * h,
                                     cc ? 0x5410 : 0x3254);
            }
          }
        }
      }
    }
    // The 8 lanes of each ray column fold their keys, each lane left with
    // its share of the columns, and merge them into the tile's.
    long long k[NT];
    int m;
    if (fold_item_keys(it, rows2, g0, lane, k, &m)) {
#pragma unroll
      for (int i = 0; i < (NT >= 4 ? NT / 4 : 1); ++i) {
        const int r = local0 + ((m + i) >> 1) * 8 + 2 * q + ((m + i) & 1);
        if (k[i] < s.best()[r]) {
          s.best()[r] = k[i];
          s.changed()[r] = 1;
        }
      }
    }
    if (p.w.exit_every && ++tested % p.w.exit_every == 0) {
      __syncthreads();  // every lane's merge is in
      bound = best_max(s, warp_max);
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < kRays; k += kBlock)
    if (s.changed()[k])
      atomicMin(keys + (int64_t)tile * kRays + k, s.best()[k]);
}

template <int NT, int WARPS, int MINB>
__global__ void __launch_bounds__(WARPS * 32, MINB)
    any_mxu_chunk_kernel(const MxuArgs p, int chunk, int* __restrict__ out) {
  static_assert(NT <= 8, "a lane's flags are one 16-bit mask");
  using Tile = MxuTile<NT, WARPS>;
  constexpr int kRays = Tile::kRays, kBlock = Tile::kBlock;
  constexpr unsigned kAll = (1u << (2 * NT)) - 1u;  // bit 2j + c per ray
  constexpr unsigned kEven = 0x55555555u & kAll;
  extern __shared__ float4 smem[];

  const Chunk c(p.w, chunk);
  if (c.lo == c.hi) return;
  const int tb = p.w.tb;
  const Tile s(smem, tb);
  const int slot4 = 8 * tb;
  stage_mxu<kBlock>(p, c.lo, s.ring);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int local0 = warp * NT * 8;
  const int gid0 = *p.w.gid_base;
  int tile = -1;
  unsigned hit = 0, hit0 = 0;  // the lane's rays' flags; as loaded
  unsigned skip = 0;  // warp-uniform: bit 2j set once column tile j is hit
  bool all = false;   // warp-uniform: every ray of the warp is hit

  // Stores 1 for each ray the tile run found hit (lanes g == 0).
  auto flush = [&]() {
    const unsigned found = hit & ~hit0;
    if (g == 0 && found) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          if (found >> (2 * j + cc) & 1u)
            out[(int64_t)tile * kRays + local0 + j * 8 + 2 * q + cc] = 1;
    }
  };
  // ORs the flags across the 8 lanes of each column and takes the votes.
  auto vote = [&]() {
#pragma unroll
    for (int off = 4; off < 32; off <<= 1)
      hit |= __shfl_xor_sync(0xffffffffu, hit, off);
    const unsigned full = __reduce_and_sync(0xffffffffu, hit);
    skip = full & (full >> 1) & kEven;
    all = full == kAll;
  };

  for (int w = c.lo; w < c.hi; ++w) {
    const int t = p.w.tile_ids[w];
    if (t != tile) {  // block-uniform
      if (tile >= 0) {
        flush();
        __syncthreads();  // every warp is done with the tile's rays
      }
      tile = t;
      s.load_rays(p.w, (int64_t)tile * kRays);
      for (int k = threadIdx.x; k < kRays; k += kBlock)
        s.tmax()[k] = p.w.rays[6 * p.w.n_rays + (int64_t)tile * kRays + k];
      hit = 0;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc)
          if (__ldcg(out + (int64_t)tile * kRays + local0 + j * 8 + 2 * q +
                     cc))  // init, or set by another block
            hit |= 1u << (2 * j + cc);
      hit0 = hit;
      vote();
    }
    wait_staged();
    // Item w's blocks and the tile's rays are in, the other slot is free,
    // and the vote: once every ray of the tile is hit, its later items
    // change nothing.
    const int tile_done = __syncthreads_and(all);
    if (w + 1 < c.hi)
      stage_mxu<kBlock>(p, w + 1, s.ring + ((w + 1 - c.lo) & 1) * slot4);
    if (tile_done) continue;
    const float* dirs_f =
        reinterpret_cast<const float*>(s.ring + ((w - c.lo) & 1) * slot4);
    const float* scal_f = dirs_f + 24 * tb;
    const int g0 = gid0 + p.w.block_ids[w] * tb;
    // Every warp splits and meets the barriers; a warp whose rays are all
    // hit tests nothing.
    for (int lo = 0; lo < tb; lo += kSplitRows) {
      const int rows = min(kSplitRows, tb - lo);
      if (lo) __syncthreads();  // every warp is done with the fragments
      split_a<kBlock>(dirs_f, tb, lo, rows, s.af());
      __syncthreads();
      int b_stride;
      const uint4* b_lane = s.b_entry(local0, g, q, &b_stride);
      for (int slice = 0; slice < rows / 16 && !all; ++slice) {
        const int row0 = lo + slice * 16;
        const uint4* af_slice = s.af() + slice * 192;
        RowScal rs;
        rs.load(scal_f, row0, g, g0);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (skip >> (2 * j) & 1u) continue;  // every ray of it is hit
          const int col = local0 + j * 8 + 2 * q;
          float den[4], kud[4], kvd[4];
          dots_mxu(af_slice, lane + opaque_zero(), b_lane[j * b_stride], den,
                   kud, kvd);
          const int2 e2 = *reinterpret_cast<const int2*>(s.ex() + col);
          const float2 m2 =
              *reinterpret_cast<const float2*>(s.tmax() + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1, cc = e & 1;
            float tt;
            if (pair_mxu(den[e], kud[e], kvd[e], rs.num[h], rs.au[h],
                         rs.av[h], &tt) &&
                rs.gid[h] != (cc ? e2.y : e2.x) && tt <= (cc ? m2.y : m2.x))
              hit |= 1u << (2 * j + cc);
          }
        }
        vote();  // the warp leaves the item once its rays are hit
      }
    }
  }
  flush();
}

// Dynamic shared memory above the 48 KB default needs an opt-in.
template <typename Fn>
cudaError_t allow_smem(Fn fn, size_t bytes) {
  if (bytes <= 48 * 1024 - 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// One K4 (nearest) or K5 chunk launch at a layout: NT column tiles per
// warp, WARPS warps per block, MINB blocks per SM asked of the register
// allocator.
template <int NT, int WARPS, int MINB, bool kNearest, typename Out>
cudaError_t mxu_chunks(const MxuArgs& p, int chunk, Out* out,
                       cudaStream_t s) {
  void (*fn)(MxuArgs, int, Out*);
  if constexpr (kNearest) {
    fn = nearest_mxu_chunk_kernel<NT, WARPS, MINB>;
  } else {
    fn = any_mxu_chunk_kernel<NT, WARPS, MINB>;
  }
  const size_t smem = MxuTile<NT, WARPS>::bytes(p.w.tb, kNearest);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  fn<<<(p.w.n_items + chunk - 1) / chunk, WARPS * 32, smem, s>>>(p, chunk,
                                                                 out);
  return cudaGetLastError();
}

// The layout per ray tile: NT = 8 column tiles per warp where rt allows
// (the A fragments a lane loads serve more pairs), 8 warps per block up to
// rt = 512 and 16 at 1024. Blocks per SM asked of the register allocator,
// chosen on the H100 at rt = 512 among those that do not spill: K4 2
// (124 registers; at 3 it spills), K5 3 (78 registers).
template <bool kNearest, typename Out>
cudaError_t mxu_for(int rt, const MxuArgs& p, int chunk, Out* out,
                    cudaStream_t s) {
  constexpr int kMinB = kNearest ? 2 : 3;
  switch (rt) {
    case 128: return mxu_chunks<2, 8, kMinB, kNearest>(p, chunk, out, s);
    case 256: return mxu_chunks<4, 8, kMinB, kNearest>(p, chunk, out, s);
    case 512: return mxu_chunks<8, 8, kMinB, kNearest>(p, chunk, out, s);
    case 1024: return mxu_chunks<8, 16, 1, kNearest>(p, chunk, out, s);
    default: return cudaErrorInvalidValue;
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

WorkArgs work_args(const float* rays, int64_t n_rays, const int* excl,
                   const float* tris, const int* tile_ids,
                   const int* block_ids, const float* entry, const int* count,
                   int n_items, const int* gid_base, int tb, int exit_every) {
  return WorkArgs{rays, n_rays, excl, reinterpret_cast<const float4*>(tris),
                  tile_ids, block_ids, entry, count, n_items, gid_base, tb,
                  exit_every};
}

// A nearest query's three launches: seed_keys, the chunks (`run`, when the
// list has slots), unpack_keys; the key launches in the query's own
// instantiation.
template <bool kShared, bool kMxu, typename Run>
cudaError_t keyed_nearest(const WorkArgs& p, const float* init_t,
                          const int* init_i, long long* keys, float* out_t,
                          int* out_i, cudaStream_t s, Run run) {
  const unsigned eg =
      (unsigned)((p.n_rays + kElemThreads - 1) / kElemThreads);
  seed_keys<kShared, kMxu><<<eg, kElemThreads, 0, s>>>(init_t, init_i, keys,
                                                       p.n_rays);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.n_items > 0 && (err = run()) != cudaSuccess) return err;
  unpack_keys<kShared, kMxu><<<eg, kElemThreads, 0, s>>>(keys, out_t, out_i,
                                                         p.n_rays);
  return cudaGetLastError();
}

// An any-hit query's copy of init into out, then the chunks (`run`, when
// the list has slots).
template <typename Run>
cudaError_t flagged_any(const WorkArgs& p, const int* init, int* out,
                        cudaStream_t s, Run run) {
  const cudaError_t err = cudaMemcpyAsync(
      out, init, p.n_rays * sizeof(int), cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess || p.n_items == 0) return err;
  return run();
}

// The nearest query in one origin form (K1, K3n).
template <bool kShared>
cudaError_t nearest_chunks(const WorkArgs& p, const float* init_t,
                           const int* init_i, long long* keys, float* out_t,
                           int* out_i, int rt, int chunk, cudaStream_t s) {
  const NearestChunkFn fn = nearest_chunk_for<kShared>(rt);
  if (fn == nullptr || chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)p.tb * 16 * sizeof(float);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  return keyed_nearest<kShared, false>(
      p, init_t, init_i, keys, out_t, out_i, s, [&]() {
        fn<<<(p.n_items + chunk - 1) / chunk, kThreads, smem, s>>>(p, chunk,
                                                                   keys);
        return cudaGetLastError();
      });
}

// The any-hit query in one origin form (K2, K3a).
template <bool kShared>
cudaError_t any_chunks(const WorkArgs& p, const int* init, int* out, int rt,
                       int chunk, cudaStream_t s) {
  const AnyChunkFn fn = any_chunk_for<kShared>(rt);
  if (fn == nullptr || chunk < 1) return cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)p.tb * 16 * sizeof(float);
  const cudaError_t err = allow_smem(fn, smem);
  if (err != cudaSuccess) return err;
  return flagged_any(p, init, out, s, [&]() {
    fn<<<(p.n_items + chunk - 1) / chunk, kThreads, smem, s>>>(p, chunk, out);
    return cudaGetLastError();
  });
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

// The tensor-core forms (K4, K5) on the chunk grid: dirs is pack_dirs's
// (3T, 8) A, indexed by ablock_ids; scal the (S, 8) fold_origin_scal rows,
// indexed (with the global ids) by block_ids. tb must be a multiple of 16.
// K4 merges through the (n_rays,) int64 keys scratch in three launches
// (seed_keys, the chunks, unpack_keys); K5 is a copy of init into out and
// the chunks.
int drt_bsr_nearest_mxu(const float* rays, int64_t n_rays, const int* excl,
                        const float* dirs, const float* scal,
                        const int* tile_ids, const int* block_ids,
                        const int* ablock_ids, const float* entry,
                        const int* count, int n_items, const float* init_t,
                        const int* init_i, const int* gid_base,
                        long long* keys, float* out_t, int* out_i, int rt,
                        int tb, int exit_every, int chunk, void* stream) {
  if (tb % 16 || chunk < 1 || rt < 128 || rt > 1024 || (rt & (rt - 1)))
    return cudaErrorInvalidValue;
  const MxuArgs p{work_args(rays, n_rays, excl, dirs, tile_ids, block_ids,
                            entry, count, n_items, gid_base, tb, exit_every),
                  reinterpret_cast<const float4*>(scal), ablock_ids};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return keyed_nearest<true, true>(
      p.w, init_t, init_i, keys, out_t, out_i, s,
      [&]() { return mxu_for<true>(rt, p, chunk, keys, s); });
}

int drt_bsr_any_mxu(const float* rays, int64_t n_rays, const int* excl,
                    const float* dirs, const float* scal, const int* tile_ids,
                    const int* block_ids, const int* ablock_ids,
                    const int* count, int n_items, const int* init,
                    const int* gid_base, int* out, int rt, int tb, int chunk,
                    void* stream) {
  if (tb % 16 || chunk < 1 || rt < 128 || rt > 1024 || (rt & (rt - 1)))
    return cudaErrorInvalidValue;
  const MxuArgs p{work_args(rays, n_rays, excl, dirs, tile_ids, block_ids,
                            nullptr, count, n_items, gid_base, tb, 0),
                  reinterpret_cast<const float4*>(scal), ablock_ids};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return flagged_any(p.w, init, out, s,
                     [&]() { return mxu_for<false>(rt, p, chunk, out, s); });
}

const char* drt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

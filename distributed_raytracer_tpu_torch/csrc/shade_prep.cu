// Stage B2 of the culled frame in one kernel: hit-tile gather, shading
// prep, light gates and per-light shadow tile hulls (ops/shade_prep.py).
//
//   shade_prep_tiles<BLOCK>  <- no Pallas kernel. In the JAX package this
//                               stage is plain jnp code (ops/render_bvh.py
//                               _stage_b2_fn: _compact_tiles,
//                               shade.prepare_packed, light_gates, the
//                               per-light cull.tile_intervals_packed) that
//                               XLA fuses into a few loops. The port's plain
//                               version (shade_prep.prep_tiles_ref) runs it
//                               as ~380 one-operation kernels, each reading
//                               and writing whole (3, C) or (8, C) rows.
//
// One block per compacted ray tile, one thread per ray (BLOCK = rt = 128,
// 256, 512 or 1024). Compacted tile j reads source tile tidx[j] of the
// frame's rays and hits, and writes everything stage C and the shadow cull
// read: the compacted hits (t, tri, valid), the 19 shading rows (x, normal,
// geometric normal, ka, kd, ks, ns), per light the forward shadow query q
// and the reversed one q_rev (stored (8, L, C), so all lights' reversed
// rays are one (8, L*C) view), the light gates, and per (light, tile) the
// hull of the reversed rays the light can colour. Optional: the compacted
// rays (only a bounce's reflection rays read them) and a per-ray viewer.
//
// What bounds it on this card: bytes. Per compacted ray it reads ~21 B of
// ray, t, tri and valid (+12 B of viewer for bounce rays) and 124 B of
// shading table from a (32, T) table that L2 holds, and writes 85 B of
// hits and shading rows and 65 B per light (q, q_rev, the gate): ~300 B a
// ray at three lights, against ~5,000 B for the plain version's one-op
// kernels. The arithmetic (~60 FP32 operations and a powf per ray and
// light) is far below the card's FP32 rate. Loads and stores are one 4-byte
// word a thread, neighbouring threads on neighbouring rays, so every row
// access of a warp is one 128-byte line; the table gather is scattered but
// neighbouring rays mostly hit neighbouring triangles.
//
// Numerics: the plain version's operation order. Built with -fmad=false
// and without --use_fast_math (ops/_build.py), every product, sum,
// division and sqrt rounds on its own, IEEE, as each one-op PyTorch kernel
// does; three-term sums run in x, y, z order (shade._sum3); the zero guards
// are torch.where's (a NaN fails `> 0` and takes the guard); clamp_min
// keeps NaN. The hulls are torch.amin / amax over the tile: a NaN
// propagates (so not fminf / fmaxf), a tile with no live ray gets the
// inverted (+inf, -inf) hull and t_hi 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kInf = INFINITY;
constexpr unsigned kFull = 0xffffffffu;

struct PrepArgs {
  const float* rays;      // (8, n_pad) ox oy oz dx dy dz tmax 0
  const float* hit_t;     // (n_pad,)
  const int* hit_tri;     // (n_pad,)
  const bool* hit_valid;  // (n_pad,)
  const float* view;      // (3,) shared viewer, or (3, n_pad) per ray
  const int64_t* tidx;    // (ht_pad,) source tile of each compacted tile
  const int* ht_count;    // () tiles with a hit
  const float* table;     // (32, n_tris) shading table
  const float* light_pos;  // (L, 3)
  const float* light_col;  // (L, 3)
  int64_t n_pad, n_tris, c;  // c = ht_pad * BLOCK compacted rays
  int ht_pad, n_lights, view_rows;
  float offset, normal_offset;
  float* rays_h;   // (8, c) or null
  float* view_h;   // (3, c), with view_rows
  float* t_h;      // (c,)
  int* tri_h;      // (c,)
  bool* valid_h;   // (c,)
  float* rows;     // (19, c): x 0:3, normal 3:6, geo_n 6:9, ka 9:12,
                   // kd 12:15, ks 15:18, ns 18
  float* q;        // (L, 8, c)
  float* q_rev;    // (8, L, c)
  bool* live;      // (L, c)
  float* hulls;    // (4, L * ht_pad, 3): o_lo, o_hi, d_lo, d_hi
  float* t_hi;     // (L * ht_pad,)
};

__device__ __forceinline__ float sum3(float a, float b, float c) {
  return (a + b) + c;
}

// torch.amin / amax of two: a NaN wins.
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// torch.clamp_min(v, 0.0): NaN stays NaN.
__device__ __forceinline__ float clamp0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.0f);
}

// shade._normalize_rows of one vector: zero (or NaN) lengths divide by 1.
__device__ __forceinline__ void normalize3(const float* v, float* out) {
  const float n = sqrtf(sum3(v[0] * v[0], v[1] * v[1], v[2] * v[2]));
  const float d = n > 0.0f ? n : 1.0f;
  out[0] = v[0] / d;
  out[1] = v[1] / d;
  out[2] = v[2] / d;
}

// The hull of one light over the block's rays: d_lo, d_hi (3 each) and
// t_hi, reduced over each warp, then over the warps by warp 0.
struct Hull {
  float lo[3], hi[3], th;

  __device__ __forceinline__ void fold(const Hull& o) {
    for (int i = 0; i < 3; ++i) {
      lo[i] = nan_min(lo[i], o.lo[i]);
      hi[i] = nan_max(hi[i], o.hi[i]);
    }
    th = nan_max(th, o.th);
  }

  __device__ __forceinline__ void warp_reduce() {
    for (int off = 16; off; off >>= 1) {
      Hull o;
      for (int i = 0; i < 3; ++i) {
        o.lo[i] = __shfl_xor_sync(kFull, lo[i], off);
        o.hi[i] = __shfl_xor_sync(kFull, hi[i], off);
      }
      o.th = __shfl_xor_sync(kFull, th, off);
      fold(o);
    }
  }
};

template <int BLOCK>
__global__ void __launch_bounds__(BLOCK) shade_prep_tiles(const PrepArgs a) {
  constexpr int kWarps = BLOCK / 32;
  // Per warp partial hulls, two lights' worth: warp 0 reads light li's
  // while the others write light li + 1's (a barrier sits between light li
  // + 2's writes and warp 0's reads of li).
  __shared__ float part[2][kWarps][7];

  const int j = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t c = a.c;
  const int64_t n = a.n_pad;
  const int64_t src = a.tidx[j] * BLOCK + tid;
  const int64_t dst = (int64_t)j * BLOCK + tid;

  // The compaction (render_bvh._compact_tiles): tiles past the hit-tile
  // count are padding, their rays invalid; invalid rays carry t 0, tri 0.
  const bool valid = a.hit_valid[src] && j < *a.ht_count;
  const float t = valid ? a.hit_t[src] : 0.0f;
  const int tri_h = valid ? a.hit_tri[src] : 0;
  a.t_h[dst] = t;
  a.tri_h[dst] = tri_h;
  a.valid_h[dst] = valid;

  float o[3], d[3];
  for (int i = 0; i < 3; ++i) {
    o[i] = a.rays[i * n + src];
    d[i] = a.rays[(3 + i) * n + src];
  }
  if (a.rays_h) {
    for (int i = 0; i < 3; ++i) {
      a.rays_h[i * c + dst] = o[i];
      a.rays_h[(3 + i) * c + dst] = d[i];
    }
    a.rays_h[6 * c + dst] = a.rays[6 * n + src];
    a.rays_h[7 * c + dst] = a.rays[7 * n + src];
  }

  // shade.prepare_packed: the exact table[:, clamp_min(tri, 0)] gather.
  const int64_t tri = tri_h < 0 ? 0 : tri_h;
  const float* gp = a.table + tri;
  float g[31];
#pragma unroll
  for (int k = 0; k < 31; ++k) g[k] = __ldg(gp + k * a.n_tris);

  // shade.prepare_packed_rows: hit point, barycentrics, shading normal.
  float x[3], rel[3];
  for (int i = 0; i < 3; ++i) {
    x[i] = o[i] + t * d[i];
    rel[i] = x[i] - g[i];
  }
  const float u = sum3(rel[0] * g[3], rel[1] * g[4], rel[2] * g[5]);
  const float v = sum3(rel[0] * g[6], rel[1] * g[7], rel[2] * g[8]);
  const float r1 = (1.0f - u) - v;
  float nn[3], nrm[3];
  for (int i = 0; i < 3; ++i)
    nn[i] = (r1 * g[9 + i] + u * g[12 + i]) + v * g[15 + i];
  normalize3(nn, nrm);
  const float* geo = g + 18;
  const float* kd = g + 24;
  const float* ks = g + 27;
  const float ns = g[30];
  for (int i = 0; i < 3; ++i) {
    a.rows[i * c + dst] = x[i];
    a.rows[(3 + i) * c + dst] = nrm[i];
    a.rows[(6 + i) * c + dst] = geo[i];
    a.rows[(9 + i) * c + dst] = g[21 + i];
    a.rows[(12 + i) * c + dst] = kd[i];
    a.rows[(15 + i) * c + dst] = ks[i];
  }
  a.rows[18 * c + dst] = ns;

  // shade.light_gates_rows: V toward the viewer.
  float w[3], cam[3];
  for (int i = 0; i < 3; ++i) {
    float vi;
    if (a.view_rows) {
      vi = a.view[i * n + src];
      a.view_h[i * c + dst] = vi;
    } else {
      vi = a.view[i];
    }
    w[i] = vi - x[i];
  }
  normalize3(w, cam);

  const int n_lights = a.n_lights;
  const int64_t lt = (int64_t)n_lights * a.ht_pad;
  for (int li = 0; li < n_lights; ++li) {
    float lp[3], lc[3];
    for (int i = 0; i < 3; ++i) {
      lp[i] = __ldg(a.light_pos + li * 3 + i);
      lc[i] = __ldg(a.light_col + li * 3 + i);
    }
    // The forward query: offset origin, unit direction, t_max.
    float tl[3], ld[3], org[3];
    for (int i = 0; i < 3; ++i) tl[i] = lp[i] - x[i];
    const float ldist = sqrtf(sum3(tl[0] * tl[0], tl[1] * tl[1],
                                   tl[2] * tl[2]));
    for (int i = 0; i < 3; ++i) ld[i] = tl[i] / ldist;
    const float side =
        sum3(geo[0] * ld[0], geo[1] * ld[1], geo[2] * ld[2]) >= 0.0f ? 1.0f
                                                                     : -1.0f;
    const float lift = a.normal_offset * side;
    for (int i = 0; i < 3; ++i)
      org[i] = (x[i] + a.offset * ld[i]) + lift * geo[i];
    float* qo = a.q + (int64_t)li * 8 * c + dst;
    for (int i = 0; i < 3; ++i) {
      qo[i * c] = org[i];
      qo[(3 + i) * c] = ld[i];
    }
    qo[6 * c] = ldist - a.offset;
    qo[7 * c] = 0.0f;

    // The reversed query: the light toward the offset point.
    float back[3], bdir[3];
    for (int i = 0; i < 3; ++i) back[i] = org[i] - lp[i];
    const float blen = sqrtf(sum3(back[0] * back[0], back[1] * back[1],
                                  back[2] * back[2]));
    const float bden = blen > 0.0f ? blen : 1.0f;
    for (int i = 0; i < 3; ++i) bdir[i] = back[i] / bden;
    float* qr = a.q_rev + (int64_t)li * c + dst;   // row k at k * L * c
    const int64_t rs = (int64_t)n_lights * c;
    for (int i = 0; i < 3; ++i) {
      qr[i * rs] = lp[i];
      qr[(3 + i) * rs] = bdir[i];
    }
    qr[6 * rs] = blen;
    qr[7 * rs] = 0.0f;

    // The gate: can this light add a nonzero Phong term here?
    const float ldn = sum3(ld[0] * nrm[0], ld[1] * nrm[1], ld[2] * nrm[2]);
    const float diff = clamp0(ldn);
    const float two = 2.0f * ldn;
    float rf[3];
    for (int i = 0; i < 3; ++i) rf[i] = two * nrm[i] - ld[i];
    const float spec =
        powf(clamp0(sum3(rf[0] * cam[0], rf[1] * cam[1], rf[2] * cam[2])),
             ns);
    bool nan = false;
    float top = -kInf;
    for (int i = 0; i < 3; ++i) {
      const float ct = (kd[i] * diff + ks[i] * spec) * lc[i];
      nan = nan || isnan(ct);
      top = fmaxf(top, ct);
    }
    const bool gate = valid && !nan && top > 0.0f;
    a.live[(int64_t)li * c + dst] = gate;

    // cull.tile_intervals_packed(q_rev[li], rt, live=gate, use_tmax=True).
    Hull h;
    for (int i = 0; i < 3; ++i) {
      h.lo[i] = gate ? bdir[i] : kInf;
      h.hi[i] = gate ? bdir[i] : -kInf;
    }
    h.th = gate ? blen : 0.0f;
    h.warp_reduce();
    float* pw = part[li & 1][warp];
    if (lane == 0) {
      for (int i = 0; i < 3; ++i) {
        pw[i] = h.lo[i];
        pw[3 + i] = h.hi[i];
      }
      pw[6] = h.th;
    }
    const int any_live = __syncthreads_or(gate);
    if (warp == 0) {
      Hull b;
      if (lane < kWarps) {
        const float* pl = part[li & 1][lane];
        for (int i = 0; i < 3; ++i) {
          b.lo[i] = pl[i];
          b.hi[i] = pl[3 + i];
        }
        b.th = pl[6];
      } else {
        for (int i = 0; i < 3; ++i) {
          b.lo[i] = kInf;
          b.hi[i] = -kInf;
        }
        b.th = -kInf;
      }
      b.warp_reduce();
      if (lane == 0) {
        const int64_t row = (int64_t)li * a.ht_pad + j;
        for (int i = 0; i < 3; ++i) {
          a.hulls[row * 3 + i] = any_live ? lp[i] : kInf;
          a.hulls[(lt + row) * 3 + i] = any_live ? lp[i] : -kInf;
          a.hulls[(2 * lt + row) * 3 + i] = b.lo[i];
          a.hulls[(3 * lt + row) * 3 + i] = b.hi[i];
        }
        a.t_hi[row] = b.th;
      }
    }
  }
}

template <int BLOCK>
int launch(const PrepArgs& a, cudaStream_t s) {
  shade_prep_tiles<BLOCK><<<a.ht_pad, BLOCK, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One launch over ht_pad blocks of rt threads on the caller's stream; rt
// must be 128, 256, 512 or 1024 and ht_pad >= 1. rays_h may be null;
// view_h is written when view_rows != 0 (view then (3, n_pad)). The Python
// wrapper (ops/shade_prep.py) checks every shape, dtype, device and
// contiguity and allocates every output.
int drt_shade_prep(const float* rays, int64_t n_pad, const float* hit_t,
                   const int* hit_tri, const bool* hit_valid,
                   const float* view, int view_rows, const int64_t* tidx,
                   const int* ht_count, int ht_pad, const float* table,
                   int64_t n_tris, const float* light_pos,
                   const float* light_col, int n_lights, float offset,
                   float normal_offset, int rt, float* rays_h, float* view_h,
                   float* t_h, int* tri_h, bool* valid_h, float* rows,
                   float* q, float* q_rev, bool* live, float* hulls,
                   float* t_hi, void* stream) {
  PrepArgs a;
  a.rays = rays;
  a.hit_t = hit_t;
  a.hit_tri = hit_tri;
  a.hit_valid = hit_valid;
  a.view = view;
  a.tidx = tidx;
  a.ht_count = ht_count;
  a.table = table;
  a.light_pos = light_pos;
  a.light_col = light_col;
  a.n_pad = n_pad;
  a.n_tris = n_tris;
  a.c = (int64_t)ht_pad * rt;
  a.ht_pad = ht_pad;
  a.n_lights = n_lights;
  a.view_rows = view_rows;
  a.offset = offset;
  a.normal_offset = normal_offset;
  a.rays_h = rays_h;
  a.view_h = view_h;
  a.t_h = t_h;
  a.tri_h = tri_h;
  a.valid_h = valid_h;
  a.rows = rows;
  a.q = q;
  a.q_rev = q_rev;
  a.live = live;
  a.hulls = hulls;
  a.t_hi = t_hi;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rt) {
    case 128: return launch<128>(a, s);
    case 256: return launch<256>(a, s);
    case 512: return launch<512>(a, s);
    case 1024: return launch<1024>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* drt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"

// Stage A of the frame for one quad: differential projection and culling.
// The one definition of the per-quad math that kernel K1
// (geometry.cu, the whole stream) and kernel K3 (raster.cu, the next
// frame's stream beside the tile raster) both run, so their outputs agree
// bit for bit; also the camera staging and the two counts they share.
//
// The math is projection.stage_a_fields of the reference package (the
// body of its `geom_block_compute`).  Per quad: decode the 32-bit word,
// project the 4 corners through the differential basis, exact plane-side
// backface test, NDC frustum test, 0.05 px^2 fan-split sub-pixel test
// (when enabled), integer screen bbox (see straddle_bounded for a quad
// with a corner at w <= 0.001 and one in front).  Span mode (a separate
// template instance, kSpanMode) takes the clip-normal backface test
// instead of the plane-side one, has no sub-pixel test, keeps the whole
// screen as a straddling quad's box, and also returns the NDC box the
// span records are built from.
//
// Rounding contract: every file that includes this header is compiled
// with -fmad=false (no multiply-add contraction), IEEE division
// (-prec-div=true) and no fast math; every expression keeps the
// reference's jnp operation order.  jnp.minimum/maximum propagate NaN and
// fminf/fmaxf do not, so the min/max are written out.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNearWEps = 0.001f;       // utils/config.py NEAR_W_EPS
constexpr float kMinTriangleArea = 0.1f;  // utils/config.py MIN_TRIANGLE_AREA
// a straddling quad's side bound holds by this share of its terms
// (ops/projection.py STRADDLE_MARGIN; a power of two, so exact)
constexpr float kStraddleMargin = 1.0f / 4096.0f;

// flag bits of a launch (ops/geometry.py BACKFACE, SUBPIXEL, SPAN); bits
// 2-3 are K1's quads a thread (geometry.cu)
constexpr int kBackface = 1;
constexpr int kSubpixelCulling = 2;
constexpr int kSpan = 16;

// The camera and the stream range of a launch: view_proj row-major,
// cam_pos, and the range [skip, n_quads) of stream indices.
struct StageACam {
  float vp[16];
  float cam[3];
  int n_quads;
  int skip;
};

// Stages the camera and the range in the block's shared copy c: threads
// 0-20 (the first warp) load one word each, then the block waits once
// (skip may be null: no quads skipped).  Every thread of the block calls
// it.
__device__ __forceinline__ void stage_camera(
    StageACam* c, const float* __restrict__ view_proj,
    const float* __restrict__ cam_pos, const int* __restrict__ n_quads,
    const int* __restrict__ skip) {
  const int t = threadIdx.x;
  if (t < 16)
    c->vp[t] = view_proj[t];
  else if (t < 19)
    c->cam[t - 16] = cam_pos[t - 16];
  else if (t == 19)
    c->n_quads = *n_quads;
  else if (t == 20)
    c->skip = skip ? *skip : 0;
  __syncthreads();
}

// The outputs of a launch: valid bool, bbx, bby, subpixel i32 and
// depth_near f32, each [gq], and counts i32[2] (subpix_total,
// valid_count), zeroed before the launch.  The wrapper
// (ops/geometry.py kernel_outputs) lays them out in one buffer.
struct StageAOut {
  unsigned char* valid;
  int* bbx;
  int* bby;
  float* dn;
  int* sub;
  int* counts;
};

struct StageAResult {
  int bbx, bby;
  float depth_near;
  bool valid, subpixel;
  float ndc[4];  // span mode: nx_min, nx_max, ny_min, ny_max
};

__device__ __forceinline__ float jmin(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b < a ? b : a;
}

__device__ __forceinline__ float jmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return b > a ? b : a;
}

__device__ __forceinline__ float sel3(int i, float a, float b, float c) {
  return i == 0 ? a : (i == 1 ? b : c);
}

// jnp.clip(x, 0, hi).astype(int32): clamp in float, truncate toward zero
__device__ __forceinline__ int clip_to_int(float x, int hi) {
  float lo_c = x < 0.0f ? 0.0f : x;
  float c = lo_c > (float)hi ? (float)hi : lo_c;
  return __float2int_rz(c);
}

// A quad with a corner on or behind the near plane (w <= kNearWEps) and
// one in front straddles it: the reference boxes it as the whole screen.
// Stage A bounds one side of its visible part (w > 0) by k, the front
// corners' NDC extreme on that axis, where that is sound: clip coordinates
// are affine across a quad, so c - k w <= 0 at all four corners gives
// c / w <= k wherever w > 0 (s = 1; s = -1 for >= k).  The front corners
// hold it by k's choice; each other corner must lie behind the camera (w <
// -kNearWEps) and hold it by kStraddleMargin of its terms, which rounding
// cannot fake.  Otherwise that side stays at the screen's edge.  A
// deliberate divergence (ops/projection.py stage_a_fields): the whole-
// screen boxes fill the binning's huge class, which keeps 64, so that
// frames lost visible quads.
__device__ __forceinline__ bool straddle_bounded(
    const float* cs, const float* ws, const bool* oks, float k, float s) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float kw = k * ws[i];
    const float d = cs[i] - kw;
    const float margin = kStraddleMargin * (fabsf(cs[i]) + fabsf(kw));
    ok = ok && (oks[i] || (ws[i] < -kNearWEps && s * d <= -margin));
  }
  return ok;
}

// Stage A of stream entry i: its word q and chunk origin (wx, wy, wz), the
// camera and range c, the frame size and the flags (kBackface,
// kSubpixelCulling; the span instance ignores the latter).
template <bool kSpanMode = false>
__device__ __forceinline__ StageAResult stage_a_math(
    int i, int q, float wx, float wy, float wz, const StageACam& c,
    int width, int height, int flags) {
  // decode (ops/projection.decode_quads)
  const float u = (float)(q & 0x1F);
  const float v = (float)((q >> 5) & 0x1F);
  const float w = (float)(((q >> 10) & 0x3F) + 1);
  const float h = (float)(((q >> 16) & 0x3F) + 1);
  const int slice_idx = (q >> 24) & 0x1F;
  const int face = (q >> 29) & 0x7;
  const bool is_pos = (face & 1) == 0;
  const float ap = (float)(is_pos ? slice_idx + 1 : slice_idx);
  const float u0 = u, v0 = v, u1 = u + w, v1 = v + h;

  // face axes (FACE_T/B/N_AXIS; faces 6/7, unused codes of the 3-bit
  // field, take face 5's, like the reference's select chains): u runs
  // along y on the x faces and along x otherwise, v along z except on the
  // z faces (y), the normal along face / 2
  const int f2 = face >> 1;
  const bool t_is_y = f2 == 0;
  const bool b_is_y = f2 >= 2;
  const int na = f2 < 2 ? f2 : 2;

  // differential basis (_Basis): o = vp @ (world + ap * n, 1) in the
  // reference's summation order
  float ot[4], tt[4], bt[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float* row = c.vp + 4 * r;
    tt[r] = t_is_y ? row[1] : row[0];
    bt[r] = b_is_y ? row[1] : row[2];
    const float nr = sel3(na, row[0], row[1], row[2]);
    ot[r] = (((row[0] * wx + row[1] * wy) + row[2] * wz) + row[3]) + ap * nr;
  }
  const float cu[4] = {u0, u1, u0, u1};
  const float cv[4] = {v0, v0, v1, v1};
#define CORNER(k, r) ((ot[r] + cu[k] * tt[r]) + cv[k] * bt[r])

  float ws[4], invs[4];
  bool oks[4];
  bool any_behind = false, all_behind = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ws[k] = CORNER(k, 3);
    const bool behind = ws[k] <= kNearWEps;
    any_behind = any_behind || behind;
    all_behind = all_behind && behind;
    invs[k] = 1.0f / (fabsf(ws[k]) > 1e-30f ? ws[k] : 1e-30f);
    oks[k] = ws[k] > kNearWEps;
  }

  float xs[4], ys[4], nxs[4], nys[4];
  const float inf = __int_as_float(0x7f800000);
  float nx_min = inf, nx_max = -inf, ny_min = inf, ny_max = -inf;
  float nz_min = inf;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    xs[k] = CORNER(k, 0);
    ys[k] = CORNER(k, 1);
    nxs[k] = xs[k] * invs[k];
    nys[k] = ys[k] * invs[k];
    const float nz = CORNER(k, 2) * invs[k];
    nx_min = jmin(nx_min, oks[k] ? nxs[k] : inf);
    nx_max = jmax(nx_max, oks[k] ? nxs[k] : -inf);
    ny_min = jmin(ny_min, oks[k] ? nys[k] : inf);
    ny_max = jmax(ny_max, oks[k] ? nys[k] : -inf);
    nz_min = jmin(nz_min, oks[k] ? nz : inf);
  }
#undef CORNER
  StageAResult res;
  res.depth_near = any_behind ? 0.0f : nz_min;

  bool in_frustum = (nx_max >= -1.0f) && (nx_min <= 1.0f) &&
                    (ny_max >= -1.0f) && (ny_min <= 1.0f) &&
                    (res.depth_near >= 0.0f) && (res.depth_near <= 1.0f);
  in_frustum = (in_frustum || any_behind) && !all_behind;

  bool front = true;
  if constexpr (kSpanMode) {
    // the clip-space normal's z below zero keeps the face: the normal's
    // column of view_proj's third row, signed by the face's direction
    if (flags & kBackface) {
      const float ncz = sel3(na, c.vp[8], c.vp[9], c.vp[10]);
      front = (is_pos ? 1.0f : -1.0f) * ncz < 0.0f;
    }
    res.ndc[0] = nx_min;
    res.ndc[1] = nx_max;
    res.ndc[2] = ny_min;
    res.ndc[3] = ny_max;
  } else if (flags & kBackface) {
    const float plane = sel3(na, wx, wy, wz) + ap;
    const float d = sel3(na, c.cam[0], c.cam[1], c.cam[2]) - plane;
    front = is_pos ? (d > 0.0f) : (d < 0.0f);
  }
  const bool in_stream = (i < c.n_quads) && (i >= c.skip);
  res.valid = in_stream && front && in_frustum;

  const float wf = (float)width, hf = (float)height;
  res.subpixel = false;
  if (!kSpanMode && (flags & kSubpixelCulling)) {
    float sxs[4], sys[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sxs[k] = ((nxs[k] + 1.0f) * 0.5f) * wf;
      sys[k] = ((1.0f - nys[k]) * 0.5f) * hf;
    }
    // doubled triangle areas of the fan split (0,1,3), (0,3,2)
    const float a013 = (sxs[3] - sxs[0]) * (sys[1] - sys[0]) -
                       (sys[3] - sys[0]) * (sxs[1] - sxs[0]);
    const float a032 = (sxs[2] - sxs[0]) * (sys[3] - sys[0]) -
                       (sys[2] - sys[0]) * (sxs[3] - sxs[0]);
    const bool tiny = (fabsf(a013) < kMinTriangleArea) &&
                      (fabsf(a032) < kMinTriangleArea) && !any_behind;
    res.subpixel = res.valid && tiny;
    res.valid = res.valid && !tiny;
  }

  // each side from the front corners' NDC box, or the screen's edge
  bool lo_x = true, hi_x = true, lo_y = true, hi_y = true;
  if (any_behind) {
    lo_x = hi_x = lo_y = hi_y = false;
    if (!kSpanMode && !all_behind) {
      lo_x = straddle_bounded(xs, ws, oks, nx_min, -1.0f);
      hi_x = straddle_bounded(xs, ws, oks, nx_max, 1.0f);
      lo_y = straddle_bounded(ys, ws, oks, ny_min, -1.0f);
      hi_y = straddle_bounded(ys, ws, oks, ny_max, 1.0f);
    }
  }
  const int bx0 =
      lo_x ? clip_to_int(floorf(((nx_min + 1.0f) * 0.5f) * wf), width - 1)
           : 0;
  const int bx1 =
      hi_x ? clip_to_int(ceilf(((nx_max + 1.0f) * 0.5f) * wf), width - 1)
           : width - 1;
  const int by0 =
      hi_y ? clip_to_int(floorf(((1.0f - ny_max) * 0.5f) * hf), height - 1)
           : 0;
  const int by1 =
      lo_y ? clip_to_int(ceilf(((1.0f - ny_min) * 0.5f) * hf), height - 1)
           : height - 1;
  res.bbx = bx0 | (bx1 << 16);
  res.bby = by0 | (by1 << 16);
  return res;
}

// Element i of the five outputs.
__device__ __forceinline__ void store_stage_a(const StageAOut& o, int i,
                                              const StageAResult& r) {
  o.valid[i] = r.valid ? 1 : 0;
  o.bbx[i] = r.bbx;
  o.bby[i] = r.bby;
  o.dn[i] = r.depth_near;
  o.sub[i] = r.subpixel ? 1 : 0;
}

// Adds the warp's subpixel and valid counts (each thread's n_sub and
// n_valid) to counts[0] and counts[1]: a warp reduction, then one atomic
// each from lane 0.  Integers, so the sums are exact in any order.  Every
// thread of the warp calls it.
__device__ __forceinline__ void count_warp(int* counts, int n_sub,
                                           int n_valid) {
  n_sub = __reduce_add_sync(0xffffffffu, n_sub);
  n_valid = __reduce_add_sync(0xffffffffu, n_valid);
  if ((threadIdx.x & 31) == 0) {
    if (n_sub) atomicAdd(counts, n_sub);
    if (n_valid) atomicAdd(counts + 1, n_valid);
  }
}

}  // namespace

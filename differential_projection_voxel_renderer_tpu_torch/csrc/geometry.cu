// K1: stage A of the frame -- differential projection and culling of the
// gathered quad stream, one thread per quad.
//
// Replaces the TPU kernel `_geom_kernel` / `geom_block_compute` of
// differential_projection_voxel_renderer_tpu/ops/geometry_pallas.py (its
// body is projection.stage_a_fields).  Per quad: decode the 32-bit word,
// project the 4 corners through the differential basis, exact plane-side
// backface test, NDC frustum test, 0.05 px^2 fan-split sub-pixel test,
// integer screen bbox (full screen if any corner has w <= 0.001).
//
// What bounds it on an H100: memory.  A quad reads 16 bytes (word + chunk
// origin) and writes 17, about 4.3 MB at the 131072-quad bucket, a few
// microseconds of HBM time; the ~300 flops per quad are far below the
// card's rate.  The design therefore keeps everything per quad in
// registers, reads the camera and the stream length straight from the
// caller's device tensors (no host sync, no staging copy: one launch per
// call), and makes every load and store coalesced (structure-of-arrays,
// thread i touches element i).
//
// Rounding contract: the frame must equal the reference's bit for bit, so
// this file is compiled with -fmad=false (no multiply-add contraction),
// IEEE division (-prec-div=true) and no fast math; every expression keeps
// the reference's jnp operation order.  jnp.minimum/maximum propagate NaN
// and fminf/fmaxf do not, so the min/max are written out.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNearWEps = 0.001f;       // utils/config.py NEAR_W_EPS
constexpr float kMinTriangleArea = 0.1f;  // utils/config.py MIN_TRIANGLE_AREA

// Per-face axes of u, v and the normal; faces 6/7 (unused codes of the
// 3-bit field) take face 5's entry, like the reference's select chains.
__constant__ int kTAxis[8] = {1, 1, 0, 0, 0, 0, 0, 0};
__constant__ int kBAxis[8] = {2, 2, 2, 2, 1, 1, 1, 1};
__constant__ int kNAxis[8] = {0, 0, 1, 1, 2, 2, 2, 2};

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

__global__ void project_cull_kernel(
    const int* __restrict__ quads, const float* __restrict__ wx_in,
    const float* __restrict__ wy_in, const float* __restrict__ wz_in,
    const float* __restrict__ view_proj, const float* __restrict__ cam_pos,
    const int* __restrict__ n_quads_in, const int* __restrict__ skip_in,
    int gq, int width, int height, int backface,
    unsigned char* __restrict__ valid_out, int* __restrict__ bbx_out,
    int* __restrict__ bby_out, float* __restrict__ dn_out,
    int* __restrict__ sub_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= gq) return;
  const int n_quads = *n_quads_in;
  const int skip = skip_in ? *skip_in : 0;
  float vp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) vp[r][c] = view_proj[4 * r + c];
  const float cam[3] = {cam_pos[0], cam_pos[1], cam_pos[2]};

  // decode (ops/projection.decode_quads)
  const int q = quads[i];
  const float u = (float)(q & 0x1F);
  const float v = (float)((q >> 5) & 0x1F);
  const float w = (float)(((q >> 10) & 0x3F) + 1);
  const float h = (float)(((q >> 16) & 0x3F) + 1);
  const int slice_idx = (q >> 24) & 0x1F;
  const int face = (q >> 29) & 0x7;
  const bool is_pos = (face & 1) == 0;
  const float ap = (float)(is_pos ? slice_idx + 1 : slice_idx);
  const float u0 = u, v0 = v, u1 = u + w, v1 = v + h;
  const float wx = wx_in[i], wy = wy_in[i], wz = wz_in[i];

  // differential basis (_Basis): o = vp @ (world + ap * n, 1) in the
  // reference's summation order
  const int ta = kTAxis[face], ba = kBAxis[face], na = kNAxis[face];
  float ot[4], tt[4], bt[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    tt[r] = sel3(ta, vp[r][0], vp[r][1], vp[r][2]);
    bt[r] = sel3(ba, vp[r][0], vp[r][1], vp[r][2]);
    const float nr = sel3(na, vp[r][0], vp[r][1], vp[r][2]);
    ot[r] = (((vp[r][0] * wx + vp[r][1] * wy) + vp[r][2] * wz) + vp[r][3])
            + ap * nr;
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

  float nxs[4], nys[4];
  const float inf = __int_as_float(0x7f800000);
  float nx_min = inf, nx_max = -inf, ny_min = inf, ny_max = -inf;
  float nz_min = inf;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    nxs[k] = CORNER(k, 0) * invs[k];
    nys[k] = CORNER(k, 1) * invs[k];
    const float nz = CORNER(k, 2) * invs[k];
    nx_min = jmin(nx_min, oks[k] ? nxs[k] : inf);
    nx_max = jmax(nx_max, oks[k] ? nxs[k] : -inf);
    ny_min = jmin(ny_min, oks[k] ? nys[k] : inf);
    ny_max = jmax(ny_max, oks[k] ? nys[k] : -inf);
    nz_min = jmin(nz_min, oks[k] ? nz : inf);
  }
#undef CORNER
  const float depth_near = any_behind ? 0.0f : nz_min;

  bool in_frustum = (nx_max >= -1.0f) && (nx_min <= 1.0f) &&
                    (ny_max >= -1.0f) && (ny_min <= 1.0f) &&
                    (depth_near >= 0.0f) && (depth_near <= 1.0f);
  in_frustum = (in_frustum || any_behind) && !all_behind;

  bool front = true;
  if (backface) {
    const float plane = sel3(na, wx, wy, wz) + ap;
    const float d = sel3(na, cam[0], cam[1], cam[2]) - plane;
    front = is_pos ? (d > 0.0f) : (d < 0.0f);
  }
  const bool in_stream = (i < n_quads) && (i >= skip);
  bool valid = in_stream && front && in_frustum;

  const float wf = (float)width, hf = (float)height;
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
  const bool subpixel = valid && tiny;
  valid = valid && !tiny;

  int bx0, bx1, by0, by1;
  if (any_behind) {
    bx0 = 0;
    bx1 = width - 1;
    by0 = 0;
    by1 = height - 1;
  } else {
    bx0 = clip_to_int(floorf(((nx_min + 1.0f) * 0.5f) * wf), width - 1);
    bx1 = clip_to_int(ceilf(((nx_max + 1.0f) * 0.5f) * wf), width - 1);
    by0 = clip_to_int(floorf(((1.0f - ny_max) * 0.5f) * hf), height - 1);
    by1 = clip_to_int(ceilf(((1.0f - ny_min) * 0.5f) * hf), height - 1);
  }
  valid_out[i] = valid ? 1 : 0;
  bbx_out[i] = bx0 | (bx1 << 16);
  bby_out[i] = by0 | (by1 << 16);
  dn_out[i] = depth_near;
  sub_out[i] = subpixel ? 1 : 0;
}

}  // namespace

// skip may be null (no quads skipped); valid is a bool (one byte) array
extern "C" int dpvr_project_cull(const void* quads, const void* quad_world,
                                 const void* view_proj, const void* cam_pos,
                                 const void* n_quads, const void* skip,
                                 int gq, int width, int height, int backface,
                                 void* valid, void* bbx, void* bby, void* dn,
                                 void* sub, void* stream) {
  const float* qw = static_cast<const float*>(quad_world);
  const int threads = 256;
  const int blocks = (gq + threads - 1) / threads;
  if (gq > 0) {
    project_cull_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(quads), qw, qw + gq, qw + 2 * (size_t)gq,
        static_cast<const float*>(view_proj),
        static_cast<const float*>(cam_pos), static_cast<const int*>(n_quads),
        static_cast<const int*>(skip), gq, width, height, backface,
        static_cast<unsigned char*>(valid),
        static_cast<int*>(bbx), static_cast<int*>(bby),
        static_cast<float*>(dn), static_cast<int*>(sub));
  }
  return (int)cudaGetLastError();
}

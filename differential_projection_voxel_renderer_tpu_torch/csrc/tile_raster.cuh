// The tile raster's per-pixel code, shared by K2/K3 (raster.cu) and K4
// (raster_packed.cu), so that both kernels round the same way by
// construction.
//
// A 16x128 tile is blended by one block of 256 threads: thread = column
// threadIdx.x & 127, rows g, g + 2, .., g + 14 for g = threadIdx.x / 128,
// colour and depth in registers.  Per pixel and item: q = A (nx, ny, 1);
// coverage qw > 0, u0 qw <= qu <= u1 qw, v0 qw <= qv <= v1 qw; planar
// depth z = z0 nx + z1 ny + z2; the texel bit (8 qv/qw & 7) * 8 +
// (8 qu/qw & 7) of the 64-bit parity mask picks colour_odd or colour_even;
// the blend is the commutative lexicographic (depth, colour) minimum.  Rows
// outside the item's octet row range (octet_rows[k / 8]) are skipped.
//
// Rounding contract: compiled with -fmad=false, IEEE division and no fast
// math; the pixel NDC and the plane evaluations keep the reference's
// operation order, with the column products a*nx hoisted per item exactly
// as the TPU kernel hoists them (_eval_bases).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileH = 16;
constexpr int kTileW = 128;
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kTileH * kTileW / kThreads;  // 8
constexpr int kChunk = 128;  // items staged per shared-memory chunk
constexpr int kFields = 20;  // 16 f32 blend fields + 4 colour/mask words
constexpr int kSky = (int)0xFF87CEEBu;  // utils/config.py SKY_COLOR

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  __syncthreads();
  return m;
}

// Shared memory of one tile block.
struct TileSmem {
  float sf[16][kChunk];
  int si[4][kChunk];
  int srow[kChunk];
  float red[kThreads / 32];
};

// This thread's pixels of tile (ty, tx): the column's NDC x, the rows' NDC
// y, and the accumulators at (+inf, sky).
__device__ __forceinline__ void init_pixels(
    int ty, int tx, int g, int col, int height, int width, float& nx,
    float (&ny)[kRowsPerThread], float (&D)[kRowsPerThread],
    int (&C)[kRowsPerThread]) {
  const float wf = (float)width, hf = (float)height;
  const float px = (float)(tx * kTileW) + (float)col;
  nx = (2.0f * (px + 0.5f) - wf) / wf;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const float py = (float)(ty * kTileH + g + 2 * j);
    ny[j] = 1.0f - (2.0f * (py + 0.5f)) / hf;
    D[j] = __int_as_float(0x7f800000);
    C[j] = kSky;
  }
}

__device__ __forceinline__ void store_pixels(
    int ty, int tx, int g, int col, int width,
    const float (&D)[kRowsPerThread], const int (&C)[kRowsPerThread],
    int* __restrict__ color_out, float* __restrict__ depth_out) {
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const size_t o = (size_t)(ty * kTileH + g + 2 * j) * width +
                     tx * kTileW + col;
    color_out[o] = C[j];
    depth_out[o] = D[j];
  }
}

// Blend staged item i into this thread's pixels: ``sf``/``si`` hold the 16
// float fields and 4 words of ``kStride`` staged items, field-major, and
// ``rr`` is the item's octet row range (r0 | r1 << 8, tile-local).
template <int kStride>
__device__ __forceinline__ void blend_item(
    const float* sf, const int* si, int i, int rr, int g, float nx,
    const float (&ny)[kRowsPerThread], float (&D)[kRowsPerThread],
    int (&C)[kRowsPerThread]) {
  const int r0 = rr & 0xFF, r1 = rr >> 8;
  // this thread's rows g + 2j that fall in [r0, r1]
  const int j0 = r0 > g ? (r0 - g + 1) >> 1 : 0;
  const int j1 = r1 >= g ? (r1 - g) >> 1 : -1;
  if (j0 > j1) return;
  const float a00 = sf[0 * kStride + i], a01 = sf[1 * kStride + i];
  const float a02 = sf[2 * kStride + i], a10 = sf[3 * kStride + i];
  const float a11 = sf[4 * kStride + i], a12 = sf[5 * kStride + i];
  const float a20 = sf[6 * kStride + i], a21 = sf[7 * kStride + i];
  const float a22 = sf[8 * kStride + i], z0 = sf[9 * kStride + i];
  const float z1 = sf[10 * kStride + i], z2 = sf[11 * kStride + i];
  const float u0 = sf[12 * kStride + i], u1 = sf[13 * kStride + i];
  const float v0 = sf[14 * kStride + i], v1 = sf[15 * kStride + i];
  const int ce = si[0 * kStride + i], co = si[1 * kStride + i];
  const int mlo = si[2 * kStride + i], mhi = si[3 * kStride + i];
  const float bu = a00 * nx, bv = a10 * nx, bw = a20 * nx, bz = z0 * nx;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (j < j0 || j > j1) continue;
    const float qu = (bu + a01 * ny[j]) + a02;
    const float qv = (bv + a11 * ny[j]) + a12;
    const float qw = (bw + a21 * ny[j]) + a22;
    const float z = (bz + z1 * ny[j]) + z2;
    const bool cover = (qw > 0.0f) && (qu >= u0 * qw) && (qu <= u1 * qw) &&
                       (qv >= v0 * qw) && (qv <= v1 * qw) && (z == z);
    if (!cover) continue;
    const float inv = 1.0f / qw;
    const int tu = __float2int_rz((qu * inv) * 8.0f) & 7;
    const int tv = __float2int_rz((qv * inv) * 8.0f) & 7;
    const int bit_idx = tv * 8 + tu;
    const unsigned word = (unsigned)(bit_idx < 32 ? mlo : mhi);
    const int c = ((word >> (bit_idx & 31)) & 1u) ? co : ce;
    if (z < D[j] || (z == D[j] && c < C[j])) {
      D[j] = z;
      C[j] = c;
    }
  }
}

// Blend items [start, end) of the stream over the whole tile, by the whole
// block: the segment's records are staged through shared memory in
// 128-item chunks (field-major records make the staging loads coalesced;
// every thread then reads the same shared word, a broadcast).  At each
// 128-aligned chunk boundary strictly inside the segment the block takes
// the max of its accumulated depth and stops once the suffix-min of the
// remaining items' near depth (octet_zmin) lies beyond it: the exact
// occlusion break, which only skips items that cannot win a pixel.  The
// group at such a boundary starts inside the segment, so its suffix-min
// bounds every later item of the segment.
__device__ __forceinline__ void walk_tile_segment(
    int start, int end, TileSmem& sm, const int* __restrict__ rec, int cap,
    const int* __restrict__ orows, const float* __restrict__ ozmin, int g,
    float nx, const float (&ny)[kRowsPerThread], float (&D)[kRowsPerThread],
    int (&C)[kRowsPerThread]) {
  for (int base = (start / kChunk) * kChunk; base < end; base += kChunk) {
    if (base > start) {
      float m = D[0];
#pragma unroll
      for (int j = 1; j < kRowsPerThread; ++j) m = fmaxf(m, D[j]);
      const float dmax = block_max(m, sm.red);
      if (ozmin[base >> 3] > dmax) break;
    }
    const int lo = start > base ? start : base;
    const int hi = end < base + kChunk ? end : base + kChunk;
    for (int idx = threadIdx.x; idx < kFields * kChunk; idx += kThreads) {
      const int f = idx / kChunk, i = idx - f * kChunk;
      const int k = base + i;
      if (k >= lo && k < hi) {
        const int val = rec[(size_t)f * cap + k];
        if (f < 16)
          sm.sf[f][i] = __int_as_float(val);
        else
          sm.si[f - 16][i] = val;
      }
    }
    for (int i = threadIdx.x; i < kChunk; i += kThreads) {
      const int k = base + i;
      if (k >= lo && k < hi) sm.srow[i] = orows[k >> 3];
    }
    __syncthreads();
    for (int k = lo; k < hi; ++k) {
      const int i = k - base;
      blend_item<kChunk>(&sm.sf[0][0], &sm.si[0][0], i, sm.srow[i], g, nx,
                         ny, D, C);
    }
    __syncthreads();
  }
}

}  // namespace

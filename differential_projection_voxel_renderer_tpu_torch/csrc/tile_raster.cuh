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
// the blend is the commutative lexicographic (depth, colour) minimum.
//
// What bounds the walk on an H100, and what this code does about it.
// Each SM holds three or four tiles whose warps run the same per-pixel
// code, so the walk is bound by instruction throughput, not by memory (an
// item's 84 bytes are staged once and then read as shared-memory
// broadcasts) and, with that many warps to an SM, not by one warp's
// latency.  So the per-item work is cut in three exact ways:
//   - rows: an item is evaluated only on the rows of its own screen box
//     (its bby, clamped to the tile) instead of its 8-item octet's union.
//     This is exact because no item covers a pixel outside its own box
//     (the box is floor/ceil of the projected corners, at least half a
//     pixel beyond every covered pixel centre; tests/test_torch_raster_walk.py
//     checks it on the test scenes).  The skip is warp-uniform: a warp
//     holds one row set of 32 columns;
//   - texels: the texel colour, with its IEEE 1/qw, two float-to-int
//     conversions and the mask lookup, is computed only where the covered
//     pixel's z <= D.  The blend can never take a pixel with z > D, so
//     this too is exact;
//   - the occlusion break is tested at every 8-item octet base inside the
//     segment (the reference's granularity), not every 128 items, with
//     one barrier (__syncthreads_and of each thread's own test).
// Tensor cores do not apply: the plane evaluations must round as the
// reference's separate float32 multiplies and adds (no TF32, no FMA).
// TMA and cp.async do not apply either: staging 84 bytes an item is far
// under 1% of an item's ~1000 cycles of instructions.
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

// Shared memory of one tile block's segment walk.
struct TileSmem {
  float sf[16][kChunk];
  int si[4][kChunk];
  int srow[kChunk];            // the item's own tile-local rows r0 | r1 << 8
  float szmin[kChunk / 8];     // octet_zmin of the chunk's octets
};

// NDC of pixel centres (the reference's _pixel_ndc).
__device__ __forceinline__ float pixel_nx(int px, int width) {
  const float wf = (float)width;
  return (2.0f * ((float)px + 0.5f) - wf) / wf;
}

__device__ __forceinline__ float pixel_ny(int py, int height) {
  return 1.0f - (2.0f * ((float)py + 0.5f)) / (float)height;
}

// threadIdx.x and blockIdx.x read afresh: indices derived from them are
// computed where they are used, not hoisted ahead of a walk and kept in
// registers (or spilled) across it.
__device__ __forceinline__ int fresh_tid() {
  int v;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(v));
  return v;
}

__device__ __forceinline__ int fresh_ctaid() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}

// This thread's first pixel of the block's tile in an [out_h, width]
// frame; its other pixels lie 2, 4, .., 14 rows below.  A warp's 32
// threads hold 32 adjacent columns of one row, so the loads and stores at
// these offsets are coalesced.
__device__ __forceinline__ size_t pixel_offset0(int tiles_x, int width) {
  const int t = fresh_ctaid(), tid = fresh_tid();
  const int ty = t / tiles_x, tx = t - ty * tiles_x;
  return (size_t)(ty * kTileH + tid / kTileW) * width + tx * kTileW +
         (tid & (kTileW - 1));
}

// The NDC y of the tile's 16 rows into shared memory ``ny`` (threads
// 0..15; the caller's next barrier publishes it), and this thread's
// accumulators.  ``py0`` is the global pixel row of the tile's first row:
// the rows' NDC is computed from the integer row, as the reference's
// y0_px + ty * tile_h + r.  The accumulators start from this thread's
// pixels of the init frame (K2's init_color/init_depth, [out_h, width],
// read at store_pixels' offsets) when one is given, else at (+inf, sky).
// The rows' NDC stays in shared memory, read as a broadcast per row, and
// the init pointers are read here only, to keep 64 registers a thread.
__device__ __forceinline__ void init_pixels(
    int py0, int height, float* ny, float (&D)[kRowsPerThread],
    int (&C)[kRowsPerThread], const int* __restrict__ init_color = nullptr,
    const float* __restrict__ init_depth = nullptr, int tiles_x = 0,
    int width = 0) {
  if (threadIdx.x < kTileH)
    ny[threadIdx.x] = pixel_ny(py0 + (int)threadIdx.x, height);
  if (init_color != nullptr) {
    const size_t o0 = pixel_offset0(tiles_x, width);
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      const size_t o = o0 + (size_t)(2 * j) * width;
      C[j] = init_color[o];
      D[j] = init_depth[o];
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    D[j] = __int_as_float(0x7f800000);
    C[j] = kSky;
  }
}

// This thread's pixels of the block's tile into the frame.
__device__ __forceinline__ void store_pixels(
    int tiles_x, int width, const float (&D)[kRowsPerThread],
    const int (&C)[kRowsPerThread], int* __restrict__ color_out,
    float* __restrict__ depth_out) {
  const size_t o0 = pixel_offset0(tiles_x, width);
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const size_t o = o0 + (size_t)(2 * j) * width;
    color_out[o] = C[j];
    depth_out[o] = D[j];
  }
}

// An item's screen rows (bby = y0 | y1 << 16) as tile-local rows
// r0 | r1 << 8, clamped to the tile whose first row is ``row0`` (the same
// clamp as the octet row ranges of rendering/pipeline.py).
__device__ __forceinline__ int tile_rows(int bby, int row0) {
  const int y0 = bby & 0xFFFF, y1 = (int)((unsigned)bby >> 16);
  const int r0 = min(max(y0 - row0, 0), kTileH - 1);
  const int r1 = min(max(y1 - row0, 0), kTileH - 1);
  return r0 | (r1 << 8);
}

__device__ __forceinline__ float max8(const float (&D)[kRowsPerThread]) {
  float m = D[0];
#pragma unroll
  for (int j = 1; j < kRowsPerThread; ++j) m = fmaxf(m, D[j]);
  return m;
}

// Blend staged item i into this thread's rows j0..j1 (NDC y ny[2 * j],
// D[j], C[j]): ``sm`` holds the 16 float fields and 4 words of the chunk's
// items, field-major.
__device__ __forceinline__ void blend_item(
    const TileSmem& sm, int i, int j0, int j1, float nx, const float* ny,
    float (&D)[kRowsPerThread], int (&C)[kRowsPerThread]) {
  const float a00 = sm.sf[0][i], a01 = sm.sf[1][i];
  const float a02 = sm.sf[2][i], a10 = sm.sf[3][i];
  const float a11 = sm.sf[4][i], a12 = sm.sf[5][i];
  const float a20 = sm.sf[6][i], a21 = sm.sf[7][i];
  const float a22 = sm.sf[8][i], z0 = sm.sf[9][i];
  const float z1 = sm.sf[10][i], z2 = sm.sf[11][i];
  const float bu = a00 * nx, bv = a10 * nx, bw = a20 * nx, bz = z0 * nx;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (j < j0 || j > j1) continue;
    const float y = ny[2 * j];
    const float qu = (bu + a01 * y) + a02;
    const float qv = (bv + a11 * y) + a12;
    const float qw = (bw + a21 * y) + a22;
    const float z = (bz + z1 * y) + z2;
    // the coverage bounds are read here, per row, which keeps them out of
    // the registers the row loop holds (64 a thread)
    const float u0 = sm.sf[12][i], u1 = sm.sf[13][i];
    const float v0 = sm.sf[14][i], v1 = sm.sf[15][i];
    const bool cover = (qw > 0.0f) && (qu >= u0 * qw) && (qu <= u1 * qw) &&
                       (qv >= v0 * qw) && (qv <= v1 * qw) && (z == z);
    // the blend below takes z < D, or z == D with a smaller colour: a
    // pixel with z > D cannot change, so its texel is never computed
    if (!cover || !(z <= D[j])) continue;
    const float inv = 1.0f / qw;
    const int tu = __float2int_rz((qu * inv) * 8.0f) & 7;
    const int tv = __float2int_rz((qv * inv) * 8.0f) & 7;
    const int bit_idx = tv * 8 + tu;
    const unsigned word = (unsigned)(bit_idx < 32 ? sm.si[2][i] : sm.si[3][i]);
    const int c = ((word >> (bit_idx & 31)) & 1u) ? sm.si[1][i] : sm.si[0][i];
    if (z < D[j] || c < C[j]) {
      D[j] = z;
      C[j] = c;
    }
  }
}

// This thread's rows g + 2j that fall in the tile-local range rr.
__device__ __forceinline__ void rows_of(int rr, int g, int& j0, int& j1) {
  const int r0 = rr & 0xFF, r1 = rr >> 8;
  j0 = r0 > g ? (r0 - g + 1) >> 1 : 0;
  j1 = r1 >= g ? (r1 - g) >> 1 : -1;
}

// Blend items [start, end) of the stream over the whole tile (first row
// ``row0``, rows' NDC y in shared ``ny``), by the whole block: the
// segment's records are staged through shared memory in 128-item chunks
// (field-major records make the staging loads coalesced; every thread then
// reads the same shared word, a broadcast), with each item's own row range
// from ``item_bby`` and the chunk's octet_zmin.  At each 8-aligned octet
// base strictly inside the segment the block stops once the suffix-min of
// the remaining items' near depth (octet_zmin) lies beyond every depth it
// holds: the exact occlusion break, which only skips items that cannot win
// a pixel.  The octet at such a base starts inside the segment, so its
// suffix-min bounds every later item of the segment.  Every thread tests
// its own pixels and one __syncthreads_and combines the tests.
__device__ __forceinline__ void walk_tile_segment(
    int start, int end, TileSmem& sm, const int* __restrict__ rec, int cap,
    const int* __restrict__ item_bby, const float* __restrict__ ozmin,
    int row0, int g, float nx, const float* ny, float (&D)[kRowsPerThread],
    int (&C)[kRowsPerThread]) {
  for (int base = (start / kChunk) * kChunk; base < end; base += kChunk) {
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
      if (k >= lo && k < hi) sm.srow[i] = tile_rows(item_bby[k], row0);
      if (i < kChunk / 8 && (base >> 3) + i < (cap >> 3))
        sm.szmin[i] = ozmin[(base >> 3) + i];
    }
    __syncthreads();
    bool stop = false;
    for (int k = lo; k < hi; ++k) {
      const int i = k - base;
      if ((k & 7) == 0 && k > start &&
          __syncthreads_and(sm.szmin[i >> 3] > max8(D))) {
        stop = true;
        break;
      }
      int j0, j1;
      rows_of(sm.srow[i], g, j0, j1);
      if (j0 <= j1) blend_item(sm, i, j0, j1, nx, ny + g, D, C);
    }
    __syncthreads();
    if (stop) break;
  }
}

}  // namespace

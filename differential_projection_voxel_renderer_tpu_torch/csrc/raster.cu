// K2: the tile raster -- blend each 16x128 framebuffer tile's segment of
// the binned item stream, one thread block per tile.
//
// Replaces the TPU kernels `_raster_kernel_shared` and `_raster_kernel`
// (both around `_walk_block`) of
// differential_projection_voxel_renderer_tpu/ops/raster.py.  Per pixel of
// the tile and per item of its segment: q = A (nx, ny, 1); coverage
// qw > 0, u0 qw <= qu <= u1 qw, v0 qw <= qv <= v1 qw; planar depth
// z = z0 nx + z1 ny + z2; the texel bit (8 qv/qw & 7) * 8 + (8 qu/qw & 7)
// of the 64-bit parity mask picks colour_odd or colour_even; the blend is
// the commutative lexicographic (depth, colour) minimum.  Rows outside the
// item's octet row range (octet_rows[k / 8]) are skipped, as on the TPU.
//
// What bounds it on an H100: arithmetic and instruction throughput, not
// memory.  A tile reads 80 bytes per item once (~8 MB per 720p frame at
// ~100k items) but evaluates up to 2048 pixels per item (22 float ops
// each, plus an IEEE divide on covered pixels).  The design keeps the tile's colour and depth
// in registers (256 threads x 8 pixels: thread = one column, rows
// g, g+2, .., g+14 for g = thread / 128, so short items still spread over
// both halves of the block), stages the segment's records through shared
// memory in 128-item chunks (field-major records make the staging loads
// coalesced; every thread then reads the same shared word, a broadcast),
// and blends serially per pixel, so no atomics are needed and block order
// is free.  At each 128-aligned chunk boundary the block takes the max of
// its accumulated depth and stops once the suffix-min of the remaining
// items' near depth (octet_zmin) lies beyond it: the exact occlusion break
// of the TPU kernel, which only skips items that cannot win a pixel.
//
// K3: K2 and the next frame's stage A in one launch of the same kernel
// (raster_kernel), for frames in flight.  Replaces `_fused_geom_pass` of
// the same TPU file, which runs the geometry kernel's math inside the
// raster call.  On the TPU the point was a flat per-call dispatch cost;
// here it is the raster's tail: K2 lasts as long as its busiest tile's
// serial walk, and most SMs idle while that tile finishes.  So the grid
// is heterogeneous: blocks [0, n_tiles) run the tile raster (raster_tile),
// and the blocks after them (none for K2) run stage A, one quad per
// thread, with the same stage_a_quad as K1 (stage_a.cuh), so K3's
// geometry equals K1's bit for bit.  Blocks are dispatched in index
// order, so the tile blocks start first and the stage-A blocks fill the
// SMs the tiles leave free.  What bounds it: K2's busiest tile plus K1's
// bytes.  Stage-A blocks use no shared memory beyond the kernel's static
// tile buffers and return before the tile code's barriers.
//
// Rounding contract: compiled with -fmad=false, IEEE division and no fast
// math; the pixel NDC and the plane evaluations keep the reference's
// operation order, with the column products a*nx hoisted per item exactly
// as the TPU kernel hoists them (_eval_bases).

#include <cuda_runtime.h>
#include <stdint.h>

#include "stage_a.cuh"

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

// Tile t of the frame, by the whole block.
__device__ __forceinline__ void raster_tile(
    int t, TileSmem& sm, const int* __restrict__ rec, int cap,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const int* __restrict__ orows, const float* __restrict__ ozmin,
    int tiles_x, int height, int width, int* __restrict__ color_out,
    float* __restrict__ depth_out) {
  float(&sf)[16][kChunk] = sm.sf;
  int(&si)[4][kChunk] = sm.si;
  int(&srow)[kChunk] = sm.srow;
  const int ty = t / tiles_x, tx = t - ty * tiles_x;
  const int start = starts[t];
  const int end = start + counts[t];
  const int col = threadIdx.x & (kTileW - 1);
  const int g = threadIdx.x / kTileW;

  const float wf = (float)width, hf = (float)height;
  const float px = (float)(tx * kTileW) + (float)col;
  const float nx = (2.0f * (px + 0.5f) - wf) / wf;
  float ny[kRowsPerThread], D[kRowsPerThread];
  int C[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const float py = (float)(ty * kTileH + g + 2 * j);
    ny[j] = 1.0f - (2.0f * (py + 0.5f)) / hf;
    D[j] = __int_as_float(0x7f800000);
    C[j] = kSky;
  }

  for (int base = (start / kChunk) * kChunk; base < end; base += kChunk) {
    if (base > start) {
      // exact occlusion break at a chunk boundary inside the segment
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
          sf[f][i] = __int_as_float(val);
        else
          si[f - 16][i] = val;
      }
    }
    for (int i = threadIdx.x; i < kChunk; i += kThreads) {
      const int k = base + i;
      if (k >= lo && k < hi) srow[i] = orows[k >> 3];
    }
    __syncthreads();

    for (int k = lo; k < hi; ++k) {
      const int i = k - base;
      const int rr = srow[i];
      const int r0 = rr & 0xFF, r1 = rr >> 8;
      // this thread's rows g + 2j that fall in [r0, r1]
      const int j0 = r0 > g ? (r0 - g + 1) >> 1 : 0;
      const int j1 = r1 >= g ? (r1 - g) >> 1 : -1;
      if (j0 > j1) continue;
      const float a00 = sf[0][i], a01 = sf[1][i], a02 = sf[2][i];
      const float a10 = sf[3][i], a11 = sf[4][i], a12 = sf[5][i];
      const float a20 = sf[6][i], a21 = sf[7][i], a22 = sf[8][i];
      const float z0 = sf[9][i], z1 = sf[10][i], z2 = sf[11][i];
      const float u0 = sf[12][i], u1 = sf[13][i];
      const float v0 = sf[14][i], v1 = sf[15][i];
      const int ce = si[0][i], co = si[1][i];
      const int mlo = si[2][i], mhi = si[3][i];
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
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const size_t o = (size_t)(ty * kTileH + g + 2 * j) * width +
                     tx * kTileW + col;
    color_out[o] = C[j];
    depth_out[o] = D[j];
  }
}

// K2 and K3: blocks [0, n_tiles) are the tile blocks; with gq2 > 0 (K3)
// the blocks past them run stage A of the next frame's stream, one quad
// per thread.
__global__ void __launch_bounds__(kThreads)
raster_kernel(const int* __restrict__ rec, int cap,
              const int* __restrict__ starts,
              const int* __restrict__ counts,
              const int* __restrict__ orows,
              const float* __restrict__ ozmin, int n_tiles, int tiles_x,
              int height, int width, int* __restrict__ color_out,
              float* __restrict__ depth_out,
              const int* __restrict__ quads2,
              const float* __restrict__ wx2,
              const float* __restrict__ wy2,
              const float* __restrict__ wz2,
              const float* __restrict__ view_proj2,
              const float* __restrict__ cam_pos2,
              const int* __restrict__ n_quads2, int gq2, int backface,
              unsigned char* __restrict__ valid_out,
              int* __restrict__ bbx_out, int* __restrict__ bby_out,
              float* __restrict__ dn_out, int* __restrict__ sub_out) {
  __shared__ TileSmem sm;
  if ((int)blockIdx.x >= n_tiles) {
    const int i = ((int)blockIdx.x - n_tiles) * kThreads + threadIdx.x;
    if (i < gq2)
      stage_a_quad(i, quads2, wx2, wy2, wz2, view_proj2, cam_pos2, n_quads2,
                   nullptr, width, height, backface, valid_out, bbx_out,
                   bby_out, dn_out, sub_out);
    return;
  }
  raster_tile(blockIdx.x, sm, rec, cap, starts, counts, orows, ozmin,
              tiles_x, height, width, color_out, depth_out);
}

}  // namespace

// K2: the tile raster, with gq2 == 0 and the stage-A pointers null.  K3:
// the same and, in the same launch, stage A of the next frame's stream
// (quads2, quad_world2 f32[3, gq2], view_proj2 f32[16], cam_pos2 f32[3],
// device scalar n_quads2) into valid/bbx/bby/dn/sub [gq2]
extern "C" int dpvr_rasterize_tiles(
    const void* records, int cap, const void* starts, const void* counts,
    const void* octet_rows, const void* octet_zmin, int tiles_y, int tiles_x,
    int height, int width, void* color, void* depth, const void* quads2,
    const void* quad_world2, const void* view_proj2, const void* cam_pos2,
    const void* n_quads2, int gq2, int backface, void* valid, void* bbx,
    void* bby, void* dn, void* sub, void* stream) {
  const int n_tiles = tiles_y * tiles_x;
  const int geom_blocks = (gq2 + kThreads - 1) / kThreads;
  const float* qw = static_cast<const float*>(quad_world2);
  if (n_tiles + geom_blocks > 0) {
    raster_kernel<<<n_tiles + geom_blocks, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(records), cap,
        static_cast<const int*>(starts), static_cast<const int*>(counts),
        static_cast<const int*>(octet_rows),
        static_cast<const float*>(octet_zmin), n_tiles, tiles_x, height,
        width, static_cast<int*>(color), static_cast<float*>(depth),
        static_cast<const int*>(quads2), qw, qw + gq2, qw + 2 * (size_t)gq2,
        static_cast<const float*>(view_proj2),
        static_cast<const float*>(cam_pos2),
        static_cast<const int*>(n_quads2), gq2, backface,
        static_cast<unsigned char*>(valid), static_cast<int*>(bbx),
        static_cast<int*>(bby), static_cast<float*>(dn),
        static_cast<int*>(sub));
  }
  return (int)cudaGetLastError();
}

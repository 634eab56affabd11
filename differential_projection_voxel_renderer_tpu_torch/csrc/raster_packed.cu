// K4: the packed tile raster -- blend each 16x128 framebuffer tile's five
// bins of the packed item stream, one thread block per tile.
//
// Replaces the TPU kernel `_raster_kernel_packed` of
// differential_projection_voxel_renderer_tpu/ops/raster_packed.py.  Tile t
// owns bins 5t (the wide bin: quads spanning more than two 32-pixel
// buckets, blended over all 128 columns) and 5t + 1 + b for b = 0..3 (the
// 32-pixel buckets: narrow quads, duplicated into each bucket they touch,
// blended over columns 32b .. 32b + 31 only).  Bin segments lie one after
// another in the stream and are not 8-aligned.  The per-pixel code is K2's
// (tile_raster.cuh), so the frame equals K2's on the same quad set bit for
// bit: the blend is commutative and each pixel sees the same items.
//
// Design.  The TPU kernel packed four buckets into one [8, 128] row
// evaluation to fill its lanes; here the lanes are threads, and K2's
// mapping (thread = column, rows g + 2j) already gives each bucket to
// exactly two warps, b and b + 4.  So:
//   - the wide phase is K2's segment walk over bin 5t, by the whole block,
//     with its 128-item chunks and block-wide occlusion break;
//   - the packed phase lets each warp pair walk its own bucket's segment
//     independently, with no block-wide barrier: the pair stages 32 items
//     at a time through its own shared memory (coalesced field-major loads
//     of 128 bytes a field, then broadcast reads) and synchronises on a
//     named barrier of 64 threads.
// The occlusion break is per bin: the bound is the max accumulated depth
// over the pixels the bin's items can touch (the tile for the wide bin,
// the bucket's 512 pixels for a bucket), tighter than the TPU's tile-wide
// bound and still exact, since a bucket item never touches another
// bucket's pixels.  It is tested only at 8-groups whose first item lies
// inside the bin (every chunk base at or past the bin's start): octet_zmin
// is a per-bin suffix-min keyed by each group's first item, so a group
// that straddles into the bin from the one before does not bound the bin.
//
// What bounds it on an H100: arithmetic and instruction throughput, as for
// K2 (each item reads 80 bytes once and is evaluated over up to 16 x 128
// pixels); a bucket item is evaluated by 64 threads instead of 256.  Busy
// buckets leave the tile's other warps idle while they finish; the kernel
// lasts as long as its busiest bin walk.

#include "tile_raster.cuh"

namespace {

constexpr int kBins = 5;        // per tile: wide, then 4 buckets
constexpr int kBucketW = 32;    // columns of a bucket (one warp's width)
constexpr int kPairChunk = 32;  // items a warp pair stages at a time

// Shared memory of one warp pair in the packed phase.
struct PairSmem {
  float sf[16][kPairChunk];
  int si[4][kPairChunk];
  int srow[kPairChunk];
  float red[2];
};

// The wide phase uses the tile's buffers, then the four pairs reuse them.
union PackedSmem {
  TileSmem tile;
  PairSmem pair[kTileW / kBucketW];
};

// Barrier of the two warps of bucket b (named barrier b + 1; barrier 0 is
// __syncthreads).
__device__ __forceinline__ void pair_sync(int b) {
  asm volatile("bar.sync %0, 64;" ::"r"(b + 1) : "memory");
}

__device__ __forceinline__ float pair_max(float v, PairSmem& ps, int b,
                                          int g) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) ps.red[g] = v;
  pair_sync(b);
  const float m = fmaxf(ps.red[0], ps.red[1]);
  pair_sync(b);
  return m;
}

// Bucket b's segment [start, end), by its warp pair.  ``p`` is the
// thread's index in the pair (0..63).
__device__ __forceinline__ void walk_bucket(
    int start, int end, int b, int p, PairSmem& ps,
    const int* __restrict__ rec, int cap, const int* __restrict__ orows,
    const float* __restrict__ ozmin, int g, float nx,
    const float (&ny)[kRowsPerThread], float (&D)[kRowsPerThread],
    int (&C)[kRowsPerThread]) {
  for (int base = (start / kPairChunk) * kPairChunk; base < end;
       base += kPairChunk) {
    if (base >= start) {
      float m = D[0];
#pragma unroll
      for (int j = 1; j < kRowsPerThread; ++j) m = fmaxf(m, D[j]);
      const float dmax = pair_max(m, ps, b, g);
      if (ozmin[base >> 3] > dmax) break;
    }
    const int lo = start > base ? start : base;
    const int hi = end < base + kPairChunk ? end : base + kPairChunk;
    for (int idx = p; idx < kFields * kPairChunk; idx += 2 * 32) {
      const int f = idx / kPairChunk, i = idx - f * kPairChunk;
      const int k = base + i;
      if (k >= lo && k < hi) {
        const int val = rec[(size_t)f * cap + k];
        if (f < 16)
          ps.sf[f][i] = __int_as_float(val);
        else
          ps.si[f - 16][i] = val;
      }
    }
    if (p < kPairChunk) {
      const int k = base + p;
      if (k >= lo && k < hi) ps.srow[p] = orows[k >> 3];
    }
    pair_sync(b);
    for (int k = lo; k < hi; ++k) {
      const int i = k - base;
      blend_item<kPairChunk>(&ps.sf[0][0], &ps.si[0][0], i, ps.srow[i], g,
                             nx, ny, D, C);
    }
    pair_sync(b);
  }
}

__global__ void __launch_bounds__(kThreads)
raster_packed_kernel(const int* __restrict__ rec, int cap,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ orows,
                     const float* __restrict__ ozmin, int tiles_x,
                     int height, int width, int* __restrict__ color_out,
                     float* __restrict__ depth_out) {
  __shared__ PackedSmem sm;
  const int t = blockIdx.x;
  const int ty = t / tiles_x, tx = t - ty * tiles_x;
  const int col = threadIdx.x & (kTileW - 1);
  const int g = threadIdx.x / kTileW;
  float nx, ny[kRowsPerThread], D[kRowsPerThread];
  int C[kRowsPerThread];
  init_pixels(ty, tx, g, col, height, width, nx, ny, D, C);

  const int w0 = starts[kBins * t];
  walk_tile_segment(w0, w0 + counts[kBins * t], sm.tile, rec, cap, orows,
                    ozmin, g, nx, ny, D, C);
  __syncthreads();  // the pairs' buffers overlay the tile's

  const int b = col / kBucketW;  // == warp & 3
  const int s = starts[kBins * t + 1 + b];
  walk_bucket(s, s + counts[kBins * t + 1 + b], b,
              g * 32 + (threadIdx.x & 31), sm.pair[b], rec, cap, orows,
              ozmin, g, nx, ny, D, C);
  store_pixels(ty, tx, g, col, width, D, C, color_out, depth_out);
}

}  // namespace

// K4: records i32[24, cap] (rows 0-19 read), starts/counts i32[tiles * 5],
// octet_rows i32[cap / 8], octet_zmin f32[cap / 8] -> color i32 and depth
// f32 [tiles_y * 16, tiles_x * 128]
extern "C" int dpvr_rasterize_packed(
    const void* records, int cap, const void* starts, const void* counts,
    const void* octet_rows, const void* octet_zmin, int tiles_y, int tiles_x,
    int height, int width, void* color, void* depth, void* stream) {
  const int n_tiles = tiles_y * tiles_x;
  if (n_tiles > 0) {
    raster_packed_kernel<<<n_tiles, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(records), cap,
        static_cast<const int*>(starts), static_cast<const int*>(counts),
        static_cast<const int*>(octet_rows),
        static_cast<const float*>(octet_zmin), tiles_x, height, width,
        static_cast<int*>(color), static_cast<float*>(depth));
  }
  return (int)cudaGetLastError();
}

// K2: the tile raster -- blend each 16x128 framebuffer tile's segment of
// the binned item stream, one thread block per tile.
//
// Replaces the TPU kernels `_raster_kernel_shared` and `_raster_kernel`
// (both around `_walk_block`) of
// differential_projection_voxel_renderer_tpu/ops/raster.py.  The per-pixel
// code (coverage, planar depth, texel colour, the commutative blend) and
// the segment walk are in tile_raster.cuh, shared with K4.
//
// What bounds it on an H100: instruction throughput, not memory.  A tile reads
// 84 bytes per item once (~8 MB per 720p frame at ~100k items) but evaluates
// up to 2048 pixels per item (22 float ops each, plus an IEEE divide on pixels
// that can win). The load is balanced: the busiest tile's work at one SM's
// share is about the average tile's, and every tile is resident at once
// (__launch_bounds__(256, 4): four blocks of 64 registers an SM, 528 slots for
// the 450 tiles of a 720p frame), so the time is the SM's instruction slots
// spent on the per-item code. The design keeps the tile's colour and depth in
// registers (256 threads x 8 pixels: thread = one column, rows g, g+2, ..,
// g+14 for g = thread / 128, so short items still spread over both halves of
// the block), stages the segment's records through shared memory in 128-item
// chunks (field-major records make the staging loads coalesced; every thread
// then reads the same shared word, a broadcast), and blends serially per
// pixel, so no atomics are needed and block order is free. tile_raster.cuh
// cuts the per-item instructions: each item is evaluated on its own rows only
// (its bby, record row 20), texels only where the pixel can still win, and the
// exact occlusion break is tested at every octet base. Why tensor cores and
// TMA do not apply, and the rounding contract: tile_raster.cuh.
//
// K3: K2 and the next frame's stage A in one launch of the same kernel
// (raster_kernel), for frames in flight.  Replaces `_fused_geom_pass` of
// the same TPU file, which runs the geometry kernel's math inside the
// raster call.  On the TPU the point was a flat per-call dispatch cost;
// here it is the raster's tail: K2 lasts as long as its busiest tile's
// serial walk, and most SMs idle while that tile finishes.  So the grid
// is heterogeneous: blocks [0, n_tiles) run the tile raster (raster_tile),
// and the blocks after them (none for K2) run stage A, one quad per
// thread, with the same stage_a_math as K1 (stage_a.cuh), so K3's
// geometry and its two counts equal K1's bit for bit.  Blocks are
// dispatched in index order, so the tile blocks start first and the
// stage-A blocks fill the SMs the tiles leave free.  What bounds it: K2's
// busiest tile plus K1's bytes.  Stage-A blocks stage the camera in the
// kernel's static tile buffers (which they use for nothing else), sync
// only among themselves and return before the tile code's barriers.

#include "stage_a.cuh"
#include "tile_raster.cuh"

namespace {

// Tile t of the frame, by the whole block.  The tile's accumulators start
// from the init frame when ``init_color`` is given (the two-pass far pass
// blends onto the near pass's frame), and its rows' NDC from global pixel
// row y0_px + ty * kTileH (a row band of a taller frame keeps global NDC;
// the items' bby rows and the output stay band-local).
__device__ __forceinline__ void raster_tile(
    int t, TileSmem& sm, const int* __restrict__ rec, int cap,
    const int* __restrict__ starts, const int* __restrict__ counts,
    const float* __restrict__ ozmin, int tiles_x, int height, int width,
    float* ny, int* __restrict__ color_out, float* __restrict__ depth_out,
    const int* __restrict__ init_color, const float* __restrict__ init_depth,
    int y0_px) {
  const int ty = t / tiles_x, tx = t - ty * tiles_x;
  const int col = threadIdx.x & (kTileW - 1);
  const int g = threadIdx.x / kTileW;
  float D[kRowsPerThread];
  int C[kRowsPerThread];
  init_pixels(y0_px + ty * kTileH, height, ny, D, C, init_color, init_depth,
              tiles_x, width);
  // record row 20 holds each item's screen rows (bby)
  walk_tile_segment(starts[t], starts[t] + counts[t], sm, rec, cap,
                    rec + (size_t)20 * cap, ozmin, ty * kTileH, g,
                    pixel_nx(tx * kTileW + col, width), ny, D, C);
  store_pixels(tiles_x, width, D, C, color_out, depth_out);
}

// K2 and K3: blocks [0, n_tiles) are the tile blocks; with gq2 > 0 (K3)
// the blocks past them run stage A of the next frame's stream, one quad
// per thread, into o2.
__global__ void __launch_bounds__(kThreads, 4)
raster_kernel(const int* __restrict__ rec, int cap,
              const int* __restrict__ starts,
              const int* __restrict__ counts,
              const float* __restrict__ ozmin, int n_tiles, int tiles_x,
              int height, int width, int* __restrict__ color_out,
              float* __restrict__ depth_out,
              const int* __restrict__ init_color,
              const float* __restrict__ init_depth, int y0_px,
              const int* __restrict__ quads2,
              const float* __restrict__ wx2,
              const float* __restrict__ wy2,
              const float* __restrict__ wz2,
              const float* __restrict__ view_proj2,
              const float* __restrict__ cam_pos2,
              const int* __restrict__ n_quads2, int gq2, int flags,
              StageAOut o2) {
  __shared__ TileSmem sm;
  __shared__ float ny[kTileH];
  if ((int)blockIdx.x >= n_tiles) {
    StageACam* c = reinterpret_cast<StageACam*>(&sm);
    stage_camera(c, view_proj2, cam_pos2, n_quads2, nullptr);
    const int i = ((int)blockIdx.x - n_tiles) * kThreads + threadIdx.x;
    StageAResult r = {};
    if (i < gq2) {
      r = stage_a_math(i, quads2[i], wx2[i], wy2[i], wz2[i], *c, width,
                       height, flags);
      store_stage_a(o2, i, r);
    }
    count_warp(o2.counts, r.subpixel, r.valid);
    return;
  }
  raster_tile(blockIdx.x, sm, rec, cap, starts, counts, ozmin, tiles_x,
              height, width, ny, color_out, depth_out, init_color,
              init_depth, y0_px);
}

}  // namespace

// K2: the tile raster on records i32[24, cap] (rows 0-19 the blend
// fields and words, row 20 each item's bby), starts/counts i32[tiles],
// octet_zmin f32[cap / 8], into color/depth [tiles_y * 16, tiles_x * 128],
// with gq2 == 0 and the stage-A pointers null.  init_color i32 and
// init_depth f32, each [tiles_y * 16, tiles_x * 128] and neither the
// output, are the frame the tiles start from (both null: SKY and +inf);
// y0_px is the global pixel row of the output's first row.  K3: the same
// and, in the same launch, stage A of the next frame's stream (quads2,
// quad_world2 f32[3, gq2], view_proj2 f32[16], cam_pos2 f32[3], device
// scalar n_quads2), with sub-pixel culling, as the reference's fused pass,
// into valid2 (bool), bbx2, bby2, sub2 (i32) and dn2 (f32), each [gq2],
// and counts2 i32[2] (subpix_total, valid_count), which it zeroes first on
// the same stream
extern "C" int dpvr_rasterize_tiles(
    const void* records, int cap, const void* starts, const void* counts,
    const void* octet_zmin, int tiles_y, int tiles_x,
    int height, int width, void* color, void* depth, const void* init_color,
    const void* init_depth, int y0_px, const void* quads2,
    const void* quad_world2, const void* view_proj2, const void* cam_pos2,
    const void* n_quads2, int gq2, int backface, void* valid2, void* bbx2,
    void* bby2, void* dn2, void* sub2, void* counts2, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = tiles_y * tiles_x;
  const int geom_blocks = (gq2 + kThreads - 1) / kThreads;
  const float* qw = static_cast<const float*>(quad_world2);
  const StageAOut o2 = {static_cast<unsigned char*>(valid2),
                        static_cast<int*>(bbx2), static_cast<int*>(bby2),
                        static_cast<float*>(dn2), static_cast<int*>(sub2),
                        static_cast<int*>(counts2)};
  if (counts2) {
    const cudaError_t err = cudaMemsetAsync(counts2, 0, 2 * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
  }
  if (n_tiles + geom_blocks > 0) {
    raster_kernel<<<n_tiles + geom_blocks, kThreads, 0, s>>>(
        static_cast<const int*>(records), cap,
        static_cast<const int*>(starts), static_cast<const int*>(counts),
        static_cast<const float*>(octet_zmin), n_tiles, tiles_x, height,
        width, static_cast<int*>(color), static_cast<float*>(depth),
        static_cast<const int*>(init_color),
        static_cast<const float*>(init_depth), y0_px,
        static_cast<const int*>(quads2), qw, qw + gq2, qw + 2 * (size_t)gq2,
        static_cast<const float*>(view_proj2),
        static_cast<const float*>(cam_pos2),
        static_cast<const int*>(n_quads2), gq2,
        (backface ? kBackface : 0) | kSubpixelCulling, o2);
  }
  return (int)cudaGetLastError();
}

// Resident blocks of raster_kernel an SM can hold (the occupancy that
// __launch_bounds__(256, 4) asks for), or -1 on an error.
extern "C" int dpvr_rasterize_tiles_blocks_per_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, raster_kernel,
                                                    kThreads, 0) !=
      cudaSuccess)
    return -1;
  return n;
}

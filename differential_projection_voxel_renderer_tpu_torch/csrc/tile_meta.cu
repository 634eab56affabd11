// The default binning's stage 5: the record gather and the octet metadata
// of the tile raster's inputs, in one launch.
//
// Replaces no TPU kernel.  The reference runs these as XLA ops between its
// binning and its raster call (rendering/pipeline.py `_render_step`: the
// 22-row record gather, the per-octet row ranges and the `jax.lax.cummin`
// of packed (tile, depth) keys); the port ran them as ~25 PyTorch ops, the
// largest a reverse `torch.cummin` over every item slot that took 0.355 ms
// of each 1280x720 frame on an H100; this kernel takes ~0.0073 ms there.
// Its plain version is ops/raster.py
// `tile_metadata_plain`, which this kernel equals bit for bit.
//
// What it computes, for the item stream of ops/raster.build_tile_lists
// (items `flat`, their tiles `t_of_item`, each tile's segment
// [starts[t], starts[t] + counts[t]) of the kept items [0, n_kept)):
// records[r, i] = all22[r, flat[i]] for the 22 rows and 0 for rows 22-23;
// octet_rows[k] = min of the 8 items' first covered tile-local row | max of
// their last << 8, each item's rows taken against its own tile;
// octet_zmin[k] = the least near depth over items 8k .. the end of the
// tile segment that holds item 8k, floor-quantized by the low bits_t bits
// of its order-preserving u32 map (bits_t = bit length of the tile count,
// which the reference's packed key gives up to the tile id), and past
// n_kept the key U32 unmapped.  The reference's single cummin over
// (tile << (32 - bits_t) | depth >> bits_t) keys reads the same: a later
// tile's keys are larger, so the suffix minimum never leaves the segment.
//
// What bounds it on an H100: bytes.  At the vd12 caps (65536 quads, 131072
// item slots) it writes 12.6 MB (24 rows) and reads all22 (5.8 MB once,
// 11.5 MB as 22 words a slot), the items and the tiles: 18-25 MB, a floor
// of 5.4-7.5 us at 3.35 TB/s.  The gather reads single words of rows that
// the step has just written, so they come from L2.  The design: one
// grid of two block kinds.  Blocks [0, n_tiles), one a tile, take the
// suffix minimum: a tile's octets from its last backwards, one octet a
// thread (the least key of its items inside the segment), a block-wide
// reverse minimum a chunk of kThreads octets with the later chunks'
// minimum carried, written at the octet heads.  A tile of L items takes
// ceil(L / 2048) chunks, so the busiest tile costs a few chunk latencies
// and not its length in steps.  The blocks after them take the gather, one
// item a thread: neighbouring threads on neighbouring items, so every
// store of a record row is coalesced; the octet row range by three
// shuffles over the 8 lanes of an octet; and the constant octet_zmin of
// the octets past n_kept.  The tile blocks come first in the grid, so the
// longest segments start first.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 22;          // the rows of all22
constexpr int kBbyRow = 20;        // each item's screen rows, y0 | y1 << 16
constexpr int kDepthRow = 21;      // each item's near depth, float bits
constexpr unsigned kFull = 0xFFFFFFFFu;

// float bits -> u32 in the floats' order
__device__ __forceinline__ unsigned order_map(unsigned b) {
  return b ^ ((b >> 31) ? kFull : 0x80000000u);
}

// the inverse of order_map
__device__ __forceinline__ unsigned order_unmap(unsigned u) {
  return (u >> 31) ? u ^ 0x80000000u : ~u;
}

// Tile t's octet heads: octet_zmin over its segment, by the whole block.
__device__ __forceinline__ void tile_suffix_min(
    int t, const int* __restrict__ depth_row, const int* __restrict__ flat,
    const int* __restrict__ starts, const int* __restrict__ counts,
    int bits_t, unsigned* __restrict__ octet_zmin) {
  __shared__ unsigned warp_min[kWarps];
  const int s = starts[t], e = s + counts[t];
  // the octets whose head 8k lies in [s, e)
  const int k0 = (s + 7) >> 3, k1 = (e + 7) >> 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned carry = kFull;  // above every key: keys are < 2^(32 - bits_t)
  for (int hi = k1; hi > k0; hi -= kThreads) {
    const int k = hi - kThreads + threadIdx.x;
    unsigned v = kFull;
    if (k >= k0) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int i = 8 * k + j;
        if (i < e)
          v = min(v, order_map((unsigned)__ldg(depth_row + __ldg(flat + i)))
                         >> bits_t);
      }
    }
    // the minimum over this thread's octet and every later one
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned o = __shfl_down_sync(kFull, v, d);
      if (lane + d < 32) v = min(v, o);
    }
    if (lane == 0) warp_min[warp] = v;
    __syncthreads();
    unsigned all = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w > warp) v = min(v, warp_min[w]);
      all = min(all, warp_min[w]);
    }
    v = min(v, carry);
    if (k >= k0) octet_zmin[k] = order_unmap(v << bits_t);
    carry = all;
    __syncthreads();  // warp_min is rewritten by the next chunk
  }
}

// Item i's record rows, and its octet's row range and (past n_kept)
// octet_zmin, by one thread; every lane of the warp takes part.
__device__ __forceinline__ void gather_item(
    int i, const int* __restrict__ all22, int rc,
    const int* __restrict__ flat, const int* __restrict__ t_of_item,
    int n_kept, int tiles_x, int tile_h, int n_items, int bits_t,
    int* __restrict__ records, int* __restrict__ octet_rows,
    unsigned* __restrict__ octet_zmin) {
  const bool in = i < n_items;
  int v[kRows];
  const int q = in ? flat[i] : 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    v[r] = in ? __ldg(all22 + (size_t)r * rc + q) : 0;
  if (in) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) records[(size_t)r * n_items + i] = v[r];
    records[(size_t)kRows * n_items + i] = 0;
    records[(size_t)(kRows + 1) * n_items + i] = 0;
  }
  const int tpy0 = ((in ? t_of_item[i] : 0) / tiles_x) * tile_h;
  const int bby = v[kBbyRow];
  int ly0 = min(max((bby & 0xFFFF) - tpy0, 0), tile_h - 1);
  int ly1 = min(max((bby >> 16) - tpy0, 0), tile_h - 1);
#pragma unroll
  for (int d = 1; d < 8; d <<= 1) {
    ly0 = min(ly0, __shfl_xor_sync(kFull, ly0, d));
    ly1 = max(ly1, __shfl_xor_sync(kFull, ly1, d));
  }
  if (in && (i & 7) == 0) {
    octet_rows[i >> 3] = ly0 | (ly1 << 8);
    if (i >= n_kept) octet_zmin[i >> 3] = order_unmap(kFull << bits_t);
  }
}

__global__ void __launch_bounds__(kThreads)
tile_meta_kernel(const int* __restrict__ all22, int rc,
                 const int* __restrict__ flat,
                 const int* __restrict__ t_of_item,
                 const int* __restrict__ starts,
                 const int* __restrict__ counts, int n_tiles, int tiles_x,
                 int tile_h, int n_items, int bits_t,
                 int* __restrict__ records, int* __restrict__ octet_rows,
                 unsigned* __restrict__ octet_zmin) {
  const int b = blockIdx.x;
  if (b < n_tiles) {
    tile_suffix_min(b, all22 + (size_t)kDepthRow * rc, flat, starts, counts,
                    bits_t, octet_zmin);
    return;
  }
  const int n_kept = starts[n_tiles - 1] + counts[n_tiles - 1];
  gather_item((b - n_tiles) * kThreads + threadIdx.x, all22, rc, flat,
              t_of_item, n_kept, tiles_x, tile_h, n_items, bits_t, records,
              octet_rows, octet_zmin);
}

}  // namespace

// Stage 5 of the default render step (ops/raster.py tile_metadata): from
// all22 i32[22, rc] and build_tile_lists' flat and t_of_item i32[n_items]
// (n_items a multiple of 8) and starts, counts i32[tiles_y * tiles_x],
// into records i32[24, n_items], octet_rows i32[n_items / 8] and
// octet_zmin f32[n_items / 8], on the stream.
extern "C" int dpvr_tile_meta(const void* all22, int rc, const void* flat,
                              const void* t_of_item, const void* starts,
                              const void* counts, int tiles_y, int tiles_x,
                              int tile_h, int n_items, void* records,
                              void* octet_rows, void* octet_zmin,
                              void* stream) {
  const int n_tiles = tiles_y * tiles_x;
  int bits_t = 1;  // max(1, bit length of n_tiles)
  while (bits_t < 31 && (n_tiles >> bits_t) != 0) ++bits_t;
  const int blocks = n_tiles + (n_items + kThreads - 1) / kThreads;
  if (n_tiles > 0 && blocks > 0) {
    tile_meta_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(all22), rc, static_cast<const int*>(flat),
        static_cast<const int*>(t_of_item), static_cast<const int*>(starts),
        static_cast<const int*>(counts), n_tiles, tiles_x, tile_h, n_items,
        bits_t, static_cast<int*>(records), static_cast<int*>(octet_rows),
        static_cast<unsigned*>(octet_zmin));
  }
  return (int)cudaGetLastError();
}

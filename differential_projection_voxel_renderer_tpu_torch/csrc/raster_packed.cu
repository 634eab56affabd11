// K4: the packed tile raster -- blend each 16x128 framebuffer tile's five
// bins of the packed item stream, one thread block per tile.
//
// Replaces the TPU kernel `_raster_kernel_packed` of
// differential_projection_voxel_renderer_tpu/ops/raster_packed.py.  Tile t
// owns bins 5t (the wide bin: quads spanning more than two 32-pixel
// buckets, blended over all 128 columns) and 5t + 1 + b for b = 0..3 (the
// 32-pixel buckets: narrow quads, duplicated into each bucket they touch,
// blended over columns 32b .. 32b + 31 only).  Bin segments lie one after
// another in the stream and are not 8-aligned.  The per-pixel arithmetic
// is K2's (the wide phase runs tile_raster.cuh's walk, the bucket phase the
// same operations in the same order), so the frame equals K2's on the same
// quad set bit for bit: the blend is commutative and each pixel sees the
// same items.
//
// What bounds it on an H100.  Like K2, instruction throughput and
// latency, not memory (each item reads 88 bytes once).  But the
// reference's within-bin order (2 bits of depth, then the row band) keeps
// a bucket's suffix-min of near depth low, so the occlusion break seldom
// fires in buckets, and a busy tile's bucket items (about a thousand in
// one bucket, 2.5 thousand in one tile at 720p) set the kernel's time.
// Walked by the bucket's own two warps with lane = column, as a plain port
// of the TPU kernel's four-bucket row packing would, they leave the tile's
// other six warps idle and most lanes too: a bucket item is ~7 columns by
// ~3 rows.  So the design:
//   - the wide phase is K2's segment walk over bin 5t, by the whole block,
//     with its octet-granular, block-wide occlusion break;
//   - then the tile's accumulators move to shared memory as 64-bit keys,
//     (order-mapped depth << 32 | order-mapped colour), whose unsigned
//     order is the blend's lexicographic order, so candidates merge with
//     atomicMin in any order;
//   - the four buckets' segments are cut into 32-item slices (32-aligned
//     in the stream, so each slice holds whole octets), and each of the
//     eight warps takes the next slice of the bucket with the most slices
//     left from shared counters.  A warp stages its slice (coalesced loads
//     of 128 bytes a field) and blends its items one after another, each
//     over the pixels of the item's own box (its bbx and bby, clamped to
//     the bucket; exact, since no item covers a pixel outside its box):
//     a box w columns wide takes 32 / w of its rows a pass, one pixel a
//     lane, so a small item is one pass of a few dependent steps instead
//     of one row of 32 lanes per row.  A covered pixel reads its key, a
//     pixel with z <= the key's depth computes its texel, and a smaller
//     (z, colour) lowers the key by atomicMin.  The keys are swizzled so
//     that lanes on different rows of one column use different banks;
//   - the occlusion break is tested at every octet base of a slice at or
//     past the bucket's start (octet_zmin is a per-bin suffix-min keyed by
//     each octet's first item, so an octet that straddles into the bin from
//     the one before does not bound it), against the max over the bucket's
//     512 pixels of the keys' depth, each an upper bound of its pixel's
//     final depth, so the break is exact.  A break stops the bucket for
//     every warp (``stop``);
//   - depth zero has two signs that the blend treats as equal, and the
//     serial blend keeps the sign of the first candidate in stream order
//     among those with depth zero and the winning colour.  The depth key
//     folds -0 into +0, and a second key per pixel keeps the smallest
//     (colour, stream position, sign) of the zero-depth candidates, the
//     wide phase's result counting as first; the store takes the sign from
//     it, so the bits written are the serial blend's;
//   - constant barrier ids only (__syncthreads, __syncwarp, warp votes),
//     and __launch_bounds__(256, 4) with 55 KB of shared memory a block:
//     every tile of a 720p frame is resident at once.
// Tensor cores and TMA do not apply, for tile_raster.cuh's reasons.

#include <atomic>

#include "tile_raster.cuh"

namespace {

constexpr int kBins = 5;                  // per tile: wide, then 4 buckets
constexpr int kBuckets = kBins - 1;
constexpr int kBucketW = 32;              // columns of a bucket
constexpr int kSlice = 32;                // items a warp walks per slice
constexpr int kWarps = kThreads / 32;
constexpr int kPixels = kTileH * kTileW;  // 2048
constexpr unsigned kFull = 0xffffffffu;

// ceil(2^32 / w) for w = 2..32: __umulhi(n, kDivMagic[w]) == n / w for
// n = 0..32 (w = 1 is taken apart)
__constant__ unsigned kDivMagic[33] = {
    0x0, 0x0, 0x80000000, 0x55555556, 0x40000000, 0x33333334, 0x2aaaaaab,
    0x24924925, 0x20000000, 0x1c71c71d, 0x1999999a, 0x1745d175, 0x15555556,
    0x13b13b14, 0x12492493, 0x11111112, 0x10000000, 0xf0f0f10, 0xe38e38f,
    0xd79435f, 0xccccccd, 0xc30c30d, 0xba2e8bb, 0xb21642d, 0xaaaaaab,
    0xa3d70a4, 0x9d89d8a, 0x97b425f, 0x924924a, 0x8d3dcb1, 0x8888889,
    0x8421085, 0x8000000};

// One warp's staged slice.
struct SliceSmem {
  float sf[16][kSlice];
  int si[4][kSlice];
  int srow[kSlice];  // the item's tile-local rows r0 | r1 << 8
  int scol[kSlice];  // its columns in the bucket c0 | c1 << 8
  float szmin[kSlice / 8];
  int bucket;
};

struct PackedSmem {
  unsigned long long key[kPixels];   // (depth, colour) at pix(row, col)
  unsigned long long zkey[kPixels];  // first zero-depth candidate
  union {
    TileSmem tile;                   // the wide phase
    SliceSmem slice[kWarps];         // the bucket phase
  } u;
  float ny[kTileH];
  float nx[kTileW];
  int bstart[kBuckets];
  int bend[kBuckets];
  int next[kBuckets];  // slices of bucket b taken so far
  int stop[kBuckets];  // bucket b's items from here on cannot win a pixel
};

constexpr size_t kSmemBytes = sizeof(PackedSmem);

// A pixel's key slot, swizzled so that a warp's lanes on one column and
// different rows fall in different banks (and 32 columns of one row still
// in 32 different slots of one 32-column group).
__device__ __forceinline__ int pix(int row, int col) {
  return row * kTileW + (col ^ row);
}

// The blend's order as an unsigned 64-bit order: depth by value (-0 as
// +0), then colour as a signed int.
__device__ __forceinline__ unsigned long long pack_key(float z, int c) {
  unsigned u = __float_as_uint(z == 0.0f ? 0.0f : z);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | ((unsigned)c ^ 0x80000000u);
}

__device__ __forceinline__ float key_depth(unsigned long long k) {
  const unsigned u = (unsigned)(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ int key_colour(unsigned long long k) {
  return (int)((unsigned)k ^ 0x80000000u);
}

// A zero-depth candidate: colour first, then its position in the serial
// blend's order (0 for the wide phase's result, 1 + stream index for a
// bucket item), then its sign bit.
__device__ __forceinline__ unsigned long long zero_key(int c, unsigned order,
                                                       float z) {
  return ((unsigned long long)((unsigned)c ^ 0x80000000u) << 32) |
         (order << 1) | (__float_as_uint(z) >> 31);
}

// An item's screen columns (bbx = x0 | x1 << 16) as columns c0 | c1 << 8 of
// the bucket whose first column on the screen is ``col0``, clamped to it.
__device__ __forceinline__ int bucket_cols(int bbx, int col0) {
  const int x0 = bbx & 0xFFFF, x1 = (int)((unsigned)bbx >> 16);
  const int c0 = min(max(x0 - col0, 0), kBucketW - 1);
  const int c1 = min(max(x1 - col0, c0), kBucketW - 1);
  return c0 | (c1 << 8);
}

// Lane 0: take the next slice of the bucket with the most slices left
// before its stop; returns base | bucket (base a multiple of 32), or -1
// when no slice is left.
__device__ __forceinline__ int take_slice(PackedSmem& sm) {
  volatile int* next = sm.next;
  volatile int* stop = sm.stop;
  for (;;) {
    int best = -1, best_left = 0;
#pragma unroll
    for (int b = 0; b < kBuckets; ++b) {
      const int s = sm.bstart[b], e = stop[b];
      const int n = e > s ? ((e - 1) >> 5) - (s >> 5) + 1 : 0;
      const int left = n - next[b];
      if (left > best_left) {
        best_left = left;
        best = b;
      }
    }
    if (best < 0) return -1;
    const int i = atomicAdd(&sm.next[best], 1);
    const int base = ((sm.bstart[best] >> 5) + i) << 5;
    if (base < stop[best]) return base | best;
  }
}

// Blend staged item i of bucket b (``order`` its place in the serial
// blend) into the tile's keys, by one warp over the pixels of the item's
// own box: a box w columns wide takes 32 / w of its rows a pass, one pixel
// a lane (lane = row offset * w + column offset).  Per pixel: the plane
// evaluations and coverage of blend_item; the key is read only where the
// pixel is covered, the texel computed only where z <= the key's depth,
// and the key lowered by atomicMin where (z, colour) is smaller.
__device__ __forceinline__ void blend_box(PackedSmem& sm,
                                          const SliceSmem& ss, int i, int b,
                                          unsigned order, int lane) {
  const int rr = ss.srow[i], cc = ss.scol[i];
  const int c0 = cc & 0xFF, w = (cc >> 8) - c0 + 1;
  const unsigned mg = kDivMagic[w];
  const int lr = w == 1 ? lane : (int)__umulhi((unsigned)lane, mg);
  const int rpp = w == 1 ? 32 : (int)__umulhi(32u, mg);
  if (lr >= rpp) return;
  const int col = b * kBucketW + c0 + (lane - lr * w);
  const float nx = sm.nx[col];
  const float* sf = &ss.sf[0][0];
  const int* si = &ss.si[0][0];
  const float a01 = sf[1 * kSlice + i], a02 = sf[2 * kSlice + i];
  const float a11 = sf[4 * kSlice + i], a12 = sf[5 * kSlice + i];
  const float a21 = sf[7 * kSlice + i], a22 = sf[8 * kSlice + i];
  const float z1 = sf[10 * kSlice + i], z2 = sf[11 * kSlice + i];
  const float u0 = sf[12 * kSlice + i], u1 = sf[13 * kSlice + i];
  const float v0 = sf[14 * kSlice + i], v1 = sf[15 * kSlice + i];
  const float bu = sf[0 * kSlice + i] * nx, bv = sf[3 * kSlice + i] * nx;
  const float bw = sf[6 * kSlice + i] * nx, bz = sf[9 * kSlice + i] * nx;
  for (int row = (rr & 0xFF) + lr; row <= (rr >> 8); row += rpp) {
    const float y = sm.ny[row];
    const float qu = (bu + a01 * y) + a02;
    const float qv = (bv + a11 * y) + a12;
    const float qw = (bw + a21 * y) + a22;
    const float z = (bz + z1 * y) + z2;
    const bool cover = (qw > 0.0f) && (qu >= u0 * qw) && (qu <= u1 * qw) &&
                       (qv >= v0 * qw) && (qv <= v1 * qw) && (z == z);
    if (!cover) continue;
    const int p = pix(row, col);
    const unsigned long long held = sm.key[p];
    // the blend takes z < D, or z == D with a smaller colour: a pixel with
    // z > D cannot change, so its texel is never computed
    if (!(z <= key_depth(held))) continue;
    const float inv = 1.0f / qw;
    const int tu = __float2int_rz((qu * inv) * 8.0f) & 7;
    const int tv = __float2int_rz((qv * inv) * 8.0f) & 7;
    const int bit_idx = tv * 8 + tu;
    const unsigned word =
        (unsigned)(bit_idx < 32 ? si[2 * kSlice + i] : si[3 * kSlice + i]);
    const int c = ((word >> (bit_idx & 31)) & 1u) ? si[1 * kSlice + i]
                                                   : si[0 * kSlice + i];
    if (z == 0.0f) atomicMin(&sm.zkey[p], zero_key(c, order, z));
    const unsigned long long mine = pack_key(z, c);
    if (mine < held) atomicMin(&sm.key[p], mine);
  }
}

// Blend items [lo, hi) of bucket b (a slice: one 32-aligned block of the
// stream, staged in ``ss`` at k & 31) by one warp.  Every item k of the
// slice lies at or past the bucket's start, so every octet base among them
// may test the break, against the max over the bucket's 512 pixels of the
// keys' depth: each an upper bound of its pixel's final depth.
__device__ __forceinline__ void walk_slice(PackedSmem& sm,
                                           const SliceSmem& ss, int b,
                                           int lo, int hi, int lane) {
  for (int k = lo; k < hi; ++k) {
    const int i = k & (kSlice - 1);
    if ((k & 7) == 0) {
      const int col = b * kBucketW + lane;
      float m = key_depth(sm.key[pix(0, col)]);
#pragma unroll
      for (int r = 1; r < kTileH; ++r)
        m = fmaxf(m, key_depth(sm.key[pix(r, col)]));
      if (__all_sync(kFull, k >= static_cast<volatile int*>(sm.stop)[b] ||
                                ss.szmin[i >> 3] > m)) {
        if (lane == 0) atomicMin(&sm.stop[b], k);
        break;
      }
    }
    blend_box(sm, ss, i, b, (unsigned)k + 1u, lane);
  }
}

// The bucket phase, by every warp: slices until none is left.
__device__ __forceinline__ void walk_buckets(
    PackedSmem& sm, const int* __restrict__ rec, int cap,
    const int* __restrict__ item_bby, const int* __restrict__ item_bbx,
    const float* __restrict__ ozmin, int tiles_x) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  SliceSmem& ss = sm.u.slice[warp];
  for (;;) {
    int pick = lane == 0 ? take_slice(sm) : 0;
    pick = __shfl_sync(kFull, pick, 0);
    if (pick < 0) break;
    const int b = pick & 31, base = pick & ~31;
    const int lo = max(sm.bstart[b], base);
    const int hi = min(sm.bend[b], base + kSlice);
    const int k = base + lane;
    // the tile's position, derived afresh for each slice (see fresh_tid)
    const int t = fresh_ctaid();
    const int ty = t / tiles_x, tx = t - ty * tiles_x;
    if (k >= lo && k < hi) {
#pragma unroll
      for (int f = 0; f < 16; ++f)
        ss.sf[f][lane] = __int_as_float(rec[(size_t)f * cap + k]);
#pragma unroll
      for (int f = 0; f < 4; ++f)
        ss.si[f][lane] = rec[(size_t)(16 + f) * cap + k];
      ss.srow[lane] = tile_rows(item_bby[k], ty * kTileH);
      ss.scol[lane] = bucket_cols(item_bbx[k], tx * kTileW + b * kBucketW);
    }
    if (lane < kSlice / 8 && (base >> 3) + lane < (cap >> 3))
      ss.szmin[lane] = ozmin[(base >> 3) + lane];
    __syncwarp();
    walk_slice(sm, ss, b, lo, hi, lane);
    __syncwarp();  // the slice's buffers are restaged
  }
}

__global__ void __launch_bounds__(kThreads, 4)
raster_packed_kernel(const int* __restrict__ rec, int cap,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const int* __restrict__ item_bby,
                     const int* __restrict__ item_bbx,
                     const float* __restrict__ ozmin, int tiles_x,
                     int height, int width, int* __restrict__ color_out,
                     float* __restrict__ depth_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PackedSmem& sm = *reinterpret_cast<PackedSmem*>(smem_raw);
  const int t = blockIdx.x;
  const int ty = t / tiles_x, tx = t - ty * tiles_x;
  const int col = threadIdx.x & (kTileW - 1);
  const int g = threadIdx.x / kTileW;
  float D[kRowsPerThread];
  int C[kRowsPerThread];
  init_pixels(ty * kTileH, height, sm.ny, D, C);

  const int w0 = starts[kBins * t];
  walk_tile_segment(w0, w0 + counts[kBins * t], sm.u.tile, rec, cap,
                    item_bby, ozmin, ty * kTileH, g,
                    pixel_nx(tx * kTileW + col, width), sm.ny, D, C);
  int n_bucket = 0;
#pragma unroll
  for (int b = 0; b < kBuckets; ++b) n_bucket += counts[kBins * t + 1 + b];
  if (n_bucket == 0) {
    store_pixels(tiles_x, width, D, C, color_out, depth_out);
    return;
  }

  // the wide phase's result becomes the keys (walk_tile_segment ended on a
  // barrier, so the slices may overlay its buffers)
  const int tid0 = fresh_tid();
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int p = pix(tid0 / kTileW + 2 * j, tid0 & (kTileW - 1));
    sm.key[p] = pack_key(D[j], C[j]);
    sm.zkey[p] = D[j] == 0.0f ? zero_key(C[j], 0u, D[j]) : ~0ull;
  }
  if (threadIdx.x < kTileW)
    sm.nx[threadIdx.x] =
        pixel_nx(fresh_ctaid() % tiles_x * kTileW + threadIdx.x, width);
  if (threadIdx.x < kBuckets) {
    const int b = threadIdx.x, s = starts[kBins * t + 1 + b];
    sm.bstart[b] = s;
    sm.bend[b] = s + counts[kBins * t + 1 + b];
    sm.stop[b] = sm.bend[b];
    sm.next[b] = 0;
  }
  __syncthreads();
  walk_buckets(sm, rec, cap, item_bby, item_bbx, ozmin, tiles_x);
  __syncthreads();

  const int tid1 = fresh_tid();
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int p = pix(tid1 / kTileW + 2 * j, tid1 & (kTileW - 1));
    const unsigned long long k = sm.key[p];
    float z = key_depth(k);
    if (z == 0.0f && (sm.zkey[p] & 1ull)) z = -0.0f;
    D[j] = z;
    C[j] = key_colour(k);
  }
  store_pixels(tiles_x, width, D, C, color_out, depth_out);
}

// Opt raster_packed_kernel into kSmemBytes of dynamic shared memory (over
// the 48 KiB default) on the current device.  The attribute is per device,
// so each card sets it on its first call; threads on one card may both set
// it, which is harmless.
cudaError_t opt_in_smem() {
  static std::atomic<bool> done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(raster_packed_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmemBytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64)
    done[dev].store(true, std::memory_order_release);
  return err;
}

}  // namespace

// K4: records i32[24, cap] (rows 0-19 read), starts/counts i32[tiles * 5],
// item_bby and item_bbx i32[cap] (each item's screen rows y0 | y1 << 16
// and columns x0 | x1 << 16), octet_zmin f32[cap / 8] -> color i32 and
// depth f32 [tiles_y * 16, tiles_x * 128]
extern "C" int dpvr_rasterize_packed(
    const void* records, int cap, const void* starts, const void* counts,
    const void* item_bby, const void* item_bbx, const void* octet_zmin,
    int tiles_y, int tiles_x, int height, int width, void* color,
    void* depth, void* stream) {
  const cudaError_t attr = opt_in_smem();
  if (attr != cudaSuccess) return (int)attr;
  const int n_tiles = tiles_y * tiles_x;
  if (n_tiles > 0) {
    raster_packed_kernel<<<n_tiles, kThreads, kSmemBytes,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(records), cap,
        static_cast<const int*>(starts), static_cast<const int*>(counts),
        static_cast<const int*>(item_bby),
        static_cast<const int*>(item_bbx),
        static_cast<const float*>(octet_zmin), tiles_x, height, width,
        static_cast<int*>(color), static_cast<float*>(depth));
  }
  return (int)cudaGetLastError();
}

// The dynamic shared memory of one raster_packed_kernel block, in bytes.
extern "C" int dpvr_rasterize_packed_smem_bytes() { return (int)kSmemBytes; }

// Resident blocks of raster_packed_kernel an SM can hold with its shared
// memory, or -1 on an error.
extern "C" int dpvr_rasterize_packed_blocks_per_sm() {
  int n = 0;
  if (opt_in_smem() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, raster_packed_kernel, kThreads, kSmemBytes) != cudaSuccess)
    return -1;
  return n;
}

// M1 and M2: the launch-floor probes, kernels of the cost-probe path
// (differential_projection_voxel_renderer_tpu_torch/benches/).
//
// Replace the Pallas kernels of the TPU cost probes: M1 the constant
// frame of benches/micro_fixed.py `variant_kernel`, micro_fixed3.py
// `kernel` and `build_h`'s `k`, and the fill family of micro_fixed2.py
// (`make` .. `make8`, `s3_idxmap`, `s4_blocked_in`); M2 the blocked copy
// family of micro_fixed2.py (`make9`, `make10`, `make11`).
//
// M1 `fill_tiles_kernel`: one block per output tile writes colour
// SKY + x_t and, where the variant has a depth output, +inf (or +inf + x_t).
// The flags select what the TPU variants differ in: where x_t comes from
// (a scalar operand, a metadata read, a record word, zero-filled shared
// scratch), which tile a block writes (row-major, an order array, always
// the first), staging the tile in shared memory before the store, the
// one-time metadata copy, and the first record block staged in shared
// memory when a tile's count is positive.  Shared memory is the variant's
// scratch size, whether or not the block touches it.
// M2 `blocked_copy_kernel`: out_k = in0 * mul_k + add_k (+ x) over int32
// [rows, 128], one block per [block_rows, 128] block, the TPU's grid step.
//
// What bounds them on an H100: memory (a 736x1280 colour and depth frame is
// 7.5 MB, 2.25 us at 3.35 TB/s; make9's 4x5 form moves 3 MB) and, at these
// sizes, the launch itself, which is what the probes measure.  The kernels
// are plain: 16-byte stores, neighbouring threads on neighbouring
// addresses.  Every operand of a variant is a kernel argument, read or not,
// as the TPU call passed it.  Integer sums wrap (unsigned arithmetic), as
// int32 sums do in the reference.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kSky = 0xFF87CEEBu;
constexpr int kThreads = 256;
constexpr int kRecRows = 24;   // rows of the records [24, cap]
constexpr int kBlockQ = 256;   // records a staged block holds
constexpr int kExtra = 5;      // operands a fill passes and never reads
constexpr int kMaxIo = 8;      // inputs, and outputs, a copy takes
constexpr int kSmemMax = 232448;

// fill flags (ops/micro.py mirrors them)
enum : int {
  kDepth = 1 << 0,         // a depth output
  kDepthAddX = 1 << 1,     // depth = +inf + x_t, else +inf
  kMapOrder = 1 << 2,      // block b writes tile order[b]
  kMapConst = 1 << 3,      // every block writes tile 0
  kXFromMeta = 1 << 4,     // x_t = counts[b * tps] + starts[b * tps]
  kXPlusScratch = 1 << 5,  // x_t += shared scratch[b], zero-filled first
  kXPlusRec = 1 << 6,      // x_t += recs[0][bidx[b] * kBlockQ]
  kTileGeo = 1 << 7,       // stage a tile's first record block if count > 0
  kMetaCopy = 1 << 8,      // block 0 copies the metadata to shared memory
  kStageTile = 1 << 9,     // build the tile in shared memory, then store
};

struct FillPtrs {
  int* color;
  float* depth;
  const int* x;
  const int* order;
  const int* starts;
  const int* counts;
  const int* meta_rows;
  const float* meta_zmin;
  const int* recs;
  const int* bidx;
  const void* extra[kExtra];
};

// host params, in order: rows, cols, tile_h, tile_w, grid_y, grid_x,
// steps_x, tps, flags, smem_a, smem_b, stage_off, smem_bytes
struct FillParams {
  int rows, cols, tile_h, tile_w, steps_x, tps, flags;
  int smem_a;     // words of the first shared array (starts, or scratch)
  int smem_b;     // words of the third (the octet metadata)
  int stage_off;  // word offset of the record stage
  int rec_cap;    // columns of the records
};

__global__ void __launch_bounds__(kThreads)
fill_tiles_kernel(FillPtrs p, FillParams q) {
  extern __shared__ __align__(16) int smem[];
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  const int tid = threadIdx.x;

  if ((q.flags & kMetaCopy) && b == 0) {
    // the TPU's one-time metadata copy at grid step 0; blocks share no
    // memory here, so the other blocks read their metadata from global
    for (int i = tid; i < q.smem_a; i += kThreads) {
      smem[i] = p.starts[i];
      smem[q.smem_a + i] = p.counts[i];
    }
    for (int i = tid; i < q.smem_b; i += kThreads) {
      smem[2 * q.smem_a + i] = p.meta_rows[i];
      smem[2 * q.smem_a + q.smem_b + i] = __float_as_int(p.meta_zmin[i]);
    }
    __syncthreads();
  }

  unsigned xt = p.x ? static_cast<unsigned>(p.x[0]) : 0u;
  if (q.flags & kXFromMeta) {
    xt = static_cast<unsigned>(p.counts[b * q.tps])
         + static_cast<unsigned>(p.starts[b * q.tps]);
  }
  if (q.flags & kXPlusRec) {
    xt += static_cast<unsigned>(p.recs[(size_t)p.bidx[b] * kBlockQ]);
  }
  if (q.flags & kXPlusScratch) {
    // the TPU read scratch that nothing wrote; here it is zero-filled
    for (int i = tid; i < q.smem_a; i += kThreads) smem[i] = 0;
    __syncthreads();
    if (b < q.smem_a) xt += static_cast<unsigned>(smem[b]);
  }

  int tile = b;
  if (q.flags & kMapOrder) tile = p.order[b];
  if (q.flags & kMapConst) tile = 0;
  const int ty = tile / q.steps_x, tx = tile % q.steps_x;
  const int row0 = ty * q.tile_h, col0 = tx * q.tile_w;
  if (tile < 0 || row0 + q.tile_h > q.rows) return;

  if (q.flags & kTileGeo) {
    // each 128-wide tile's starts/counts, and its first record block
    // staged when its count is positive (the TPU started that copy and
    // never waited on it)
    const int tiles_x = q.steps_x * q.tps;
    const int stride = 2 * q.tps * kBlockQ;
    for (int j = 0; j < q.tps; ++j) {
      const int t = ty * tiles_x + tx * q.tps + j;
      const int off = p.starts[t] / kBlockQ * kBlockQ;
      if (p.counts[t] > 0 && off >= 0 && off + kBlockQ <= q.rec_cap) {
        int* dst = smem + q.stage_off + 2 * j * kBlockQ;
        for (int i = tid; i < kRecRows * kBlockQ; i += kThreads) {
          const int r = i / kBlockQ, c = i % kBlockQ;
          dst[r * stride + c] = p.recs[(size_t)r * q.rec_cap + off + c];
        }
      }
    }
  }

  const int c = static_cast<int>(kSky + xt);
  float d = __int_as_float(0x7f800000);
  if (q.flags & kDepthAddX) {
    d = __fadd_rn(d, __int2float_rn(static_cast<int>(xt)));
  }
  const int4 cv = make_int4(c, c, c, c);
  const float4 dv = make_float4(d, d, d, d);
  const int n4 = q.tile_h * q.tile_w / 4;
  int4* scol = reinterpret_cast<int4*>(smem);
  float4* sdep = reinterpret_cast<float4*>(smem) + n4;
  const bool staged = q.flags & kStageTile;
  if (staged) {
    for (int i = tid; i < n4; i += kThreads) {
      scol[i] = cv;
      sdep[i] = dv;
    }
    __syncthreads();
  }
  for (int i = tid; i < n4; i += kThreads) {
    const int e = 4 * i;
    const size_t off = (size_t)(row0 + e / q.tile_w) * q.cols + col0
                       + e % q.tile_w;
    *reinterpret_cast<int4*>(p.color + off) = staged ? scol[i] : cv;
    if (q.flags & kDepth) {
      *reinterpret_cast<float4*>(p.depth + off) = staged ? sdep[i] : dv;
    }
  }
}

struct CopyPtrs {
  const int* in[kMaxIo];
  int* out[kMaxIo];
  const int* x;
};

// host params, in order: rows, block_rows, n_in, n_out, x_mask, then
// mul[kMaxIo], add[kMaxIo]
struct CopyParams {
  int n_out, x_mask, block_elems;
  int mul[kMaxIo], add[kMaxIo];
};

__global__ void __launch_bounds__(kThreads)
blocked_copy_kernel(CopyPtrs p, CopyParams q) {
  const size_t base = (size_t)blockIdx.x * q.block_elems;
  const unsigned x = static_cast<unsigned>(p.x[0]);
  for (int i = 4 * threadIdx.x; i < q.block_elems; i += 4 * kThreads) {
    // the whole vector is read before any output is written, so out0 may
    // be in0 (the in-place form)
    const int4 v = *reinterpret_cast<const int4*>(p.in[0] + base + i);
#pragma unroll
    for (int k = 0; k < kMaxIo; ++k) {
      if (k < q.n_out) {
        const unsigned m = static_cast<unsigned>(q.mul[k]);
        const unsigned a = static_cast<unsigned>(q.add[k])
                           + (((q.x_mask >> k) & 1) ? x : 0u);
        int4 o;
        o.x = static_cast<int>(static_cast<unsigned>(v.x) * m + a);
        o.y = static_cast<int>(static_cast<unsigned>(v.y) * m + a);
        o.z = static_cast<int>(static_cast<unsigned>(v.z) * m + a);
        o.w = static_cast<int>(static_cast<unsigned>(v.w) * m + a);
        *reinterpret_cast<int4*>(p.out[k] + base + i) = o;
      }
    }
  }
}

int g_fill_smem = 48 * 1024;  // dynamic shared memory the kernel may take

}  // namespace

// extra0..4 are operands the variant passes and the kernel never reads;
// any pointer may be null where its flag is off
extern "C" int dpvr_fill_tiles(void* color, void* depth, const void* x,
                               const void* order, const void* starts,
                               const void* counts, const void* meta_rows,
                               const void* meta_zmin, const void* recs,
                               const void* bidx, const void* extra0,
                               const void* extra1, const void* extra2,
                               const void* extra3, const void* extra4,
                               int rec_cap, const int* params, void* stream) {
  FillPtrs p{static_cast<int*>(color), static_cast<float*>(depth),
             static_cast<const int*>(x), static_cast<const int*>(order),
             static_cast<const int*>(starts), static_cast<const int*>(counts),
             static_cast<const int*>(meta_rows),
             static_cast<const float*>(meta_zmin),
             static_cast<const int*>(recs), static_cast<const int*>(bidx),
             {extra0, extra1, extra2, extra3, extra4}};
  FillParams q{params[0], params[1], params[2], params[3], params[6],
               params[7], params[8], params[9], params[10], params[11],
               rec_cap};
  const dim3 grid(params[5], params[4]);
  const int smem = params[12];
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > g_fill_smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        fill_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemMax);
    if (err != cudaSuccess) return (int)err;
    g_fill_smem = kSmemMax;
  }
  fill_tiles_kernel<<<grid, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(p, q);
  return (int)cudaGetLastError();
}

// in1..7 are passed and never read (in0 is the copy's source); the outputs
// past n_out and the inputs past n_in are null
extern "C" int dpvr_blocked_copy(
    const void* in0, const void* in1, const void* in2, const void* in3,
    const void* in4, const void* in5, const void* in6, const void* in7,
    void* out0, void* out1, void* out2, void* out3, void* out4, void* out5,
    void* out6, void* out7, const void* x, const int* params,
    void* stream) {
  CopyPtrs p{{static_cast<const int*>(in0), static_cast<const int*>(in1),
              static_cast<const int*>(in2), static_cast<const int*>(in3),
              static_cast<const int*>(in4), static_cast<const int*>(in5),
              static_cast<const int*>(in6), static_cast<const int*>(in7)},
             {static_cast<int*>(out0), static_cast<int*>(out1),
              static_cast<int*>(out2), static_cast<int*>(out3),
              static_cast<int*>(out4), static_cast<int*>(out5),
              static_cast<int*>(out6), static_cast<int*>(out7)},
             static_cast<const int*>(x)};
  const int rows = params[0], block_rows = params[1];
  CopyParams q{params[3], params[4], block_rows * 128, {}, {}};
  for (int k = 0; k < kMaxIo; ++k) {
    q.mul[k] = params[5 + k];
    q.add[k] = params[5 + kMaxIo + k];
  }
  if (rows > 0) {
    blocked_copy_kernel<<<rows / block_rows, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p, q);
  }
  return (int)cudaGetLastError();
}

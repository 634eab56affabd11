// M1 and M2: the launch-floor probes, kernels of the cost-probe path
// (differential_projection_voxel_renderer_tpu_torch/benches/).
//
// Replace the Pallas kernels of the TPU cost probes: M1 the constant
// frame of benches/micro_fixed.py `variant_kernel`, micro_fixed3.py
// `kernel` and `build_h`'s `k`, and the fill family of micro_fixed2.py
// (`make` .. `make8`, `s3_idxmap`, `s4_blocked_in`); M2 the blocked copy
// family of micro_fixed2.py (`make9`, `make10`, `make11`).
//
// M1 `fill_tiles_kernel`: step b of the reference's grid writes its tile
// with colour SKY + x_t and, where the variant has a depth output, +inf
// (or +inf + x_t).  The CUDA grid is not the TPU's: thread g writes the
// 16-byte vector g % n4 of step g / n4's tile (n4 vectors a tile), so the
// 736x1280 frame is 235520 threads in 920 blocks of 256, about one wave of
// 132 SMs at 8 blocks an SM, and neighbouring threads store to
// neighbouring addresses along a tile row.  The flags keep what decides a
// value: where x_t comes from (a scalar operand, a metadata read, a record
// word, a zero-filled shared word), which tile step b writes (row-major,
// order[b], or tile 0 -- written once, with the last step's value, as the
// TPU's sequential grid leaves it), and the block's vectors staged in
// shared memory before the store.  The TPU's one-time metadata copy and
// its record-block stage decided no value and have no counterpart here; a
// block reserves only the shared memory it reads, none for the plain fill
// (ops/micro.py FillLayout.plan computes the launch).
// M2 `blocked_copy_kernel`: out_k = in0 * mul_k + add_k (+ x) over int32
// [rows, 128], one 16-byte vector of in0 a thread, 128 threads a block:
// 256 blocks at [1024, 128], every SM at work.  The TPU's block_rows
// (its grid step) is checked and no longer shapes the grid.
//
// What bounds them on an H100: memory (a 736x1280 colour and depth frame is
// 7.5 MB, 2.25 us at 3.35 TB/s; make9's 4x5 form moves 3 MB) and, at these
// sizes, the launch itself, which is what the probes measure.  Every
// operand of a variant is a kernel argument, read or not, as the TPU call
// passed it.  Integer sums wrap (unsigned arithmetic), as int32 sums do in
// the reference.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kSky = 0xFF87CEEBu;
constexpr int kFillThreads = 256;
constexpr int kCopyThreads = 128;
constexpr int kBlockQ = 256;   // records a record block holds
constexpr int kExtra = 5;      // operands a fill passes and never reads
constexpr int kMaxIo = 8;      // inputs, and outputs, a copy takes
constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory, no opt-in

// fill flags (ops/micro.py mirrors them)
enum : int {
  kDepth = 1 << 0,         // a depth output
  kDepthAddX = 1 << 1,     // depth = +inf + x_t, else +inf
  kMapOrder = 1 << 2,      // step b writes tile order[b]
  kMapConst = 1 << 3,      // every step writes tile 0
  kXFromMeta = 1 << 4,     // x_t = counts[b * tps] + starts[b * tps]
  kXPlusScratch = 1 << 5,  // x_t += a zero-filled shared word of step b
  kXPlusRec = 1 << 6,      // x_t += recs[0][bidx[b] * kBlockQ]
  kStageTile = 1 << 7,     // stage the block's vectors in shared memory
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

// host params, in order: the fields below, then blocks, threads and
// smem_bytes (ops/micro.py FillLayout.c_params)
struct FillParams {
  int rows, cols, tile_h, tile_w;
  int tile_rows;      // whole tiles down the frame: rows / tile_h
  int steps_x, tps, flags;
  int step0;          // the first step the grid writes (MAP_CONST: the last)
  int n4;             // 16-byte vectors of a tile
  int total;          // vectors the grid writes: n4 a step written
  int scratch_off;    // word offset of X_PLUS_SCRATCH's words
  int scratch_words;  // the most steps a block spans
};

__global__ void __launch_bounds__(kFillThreads)
fill_tiles_kernel(FillPtrs p, FillParams q) {
  extern __shared__ __align__(16) int smem[];
  const int tid = threadIdx.x;
  const int g = blockIdx.x * kFillThreads + tid;
  // threads past the end compute the last vector's value and store nothing
  const int gc = min(g, q.total - 1);
  const int s = gc / q.n4;
  const int i = gc - s * q.n4;
  const int b = q.step0 + s;

  unsigned xt = p.x ? static_cast<unsigned>(p.x[0]) : 0u;
  if (q.flags & kXFromMeta) {
    xt = static_cast<unsigned>(p.counts[b * q.tps])
         + static_cast<unsigned>(p.starts[b * q.tps]);
  }
  if (q.flags & kXPlusRec) {
    xt += static_cast<unsigned>(p.recs[(size_t)p.bidx[b] * kBlockQ]);
  }
  if (q.flags & kXPlusScratch) {
    // the TPU read scratch that nothing wrote; here each step the block
    // spans has a shared word, zero-filled
    int* words = smem + q.scratch_off;
    for (int w = tid; w < q.scratch_words; w += kFillThreads) words[w] = 0;
    __syncthreads();
    xt += static_cast<unsigned>(
        words[s - blockIdx.x * kFillThreads / q.n4]);
  }

  int tile = b;
  if (q.flags & kMapOrder) tile = p.order[b];
  if (q.flags & kMapConst) tile = 0;
  const int ty = tile / q.steps_x, tx = tile - ty * q.steps_x;
  const bool store = g < q.total && tile >= 0 && ty < q.tile_rows;

  const int c = static_cast<int>(kSky + xt);
  float d = __int_as_float(0x7f800000);
  if (q.flags & kDepthAddX) {
    d = __fadd_rn(d, __int2float_rn(static_cast<int>(xt)));
  }
  int4 cv = make_int4(c, c, c, c);
  float4 dv = make_float4(d, d, d, d);
  if (q.flags & kStageTile) {
    // the TPU built its tile in VMEM and copied it out; here the block
    // builds its vectors in shared memory and stores them from there
    int4* scol = reinterpret_cast<int4*>(smem);
    float4* sdep = reinterpret_cast<float4*>(smem) + kFillThreads;
    scol[tid] = cv;
    if (q.flags & kDepth) sdep[tid] = dv;
    __syncthreads();
    cv = scol[tid];
    if (q.flags & kDepth) dv = sdep[tid];
  }
  if (store) {
    const int e = 4 * i;
    const int r = e / q.tile_w;
    const size_t off = (size_t)(ty * q.tile_h + r) * q.cols
                       + tx * q.tile_w + (e - r * q.tile_w);
    *reinterpret_cast<int4*>(p.color + off) = cv;
    if (q.flags & kDepth) *reinterpret_cast<float4*>(p.depth + off) = dv;
  }
}

struct CopyPtrs {
  const int* in[kMaxIo];
  int* out[kMaxIo];
  const int* x;
};

// host params, in order: rows, block_rows, n_in, n_out, x_mask, blocks,
// threads, then mul[kMaxIo], add[kMaxIo] (ops/micro.py _copy_params)
struct CopyParams {
  int n_out, x_mask, n4;
  int mul[kMaxIo], add[kMaxIo];
};

__global__ void __launch_bounds__(kCopyThreads)
blocked_copy_kernel(CopyPtrs p, CopyParams q) {
  const int g = blockIdx.x * kCopyThreads + threadIdx.x;
  if (g >= q.n4) return;
  const unsigned x = static_cast<unsigned>(p.x[0]);
  // the whole vector is read before any output is written, and no other
  // thread writes it, so out0 may be in0 (the in-place form)
  const int4 v = reinterpret_cast<const int4*>(p.in[0])[g];
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
      reinterpret_cast<int4*>(p.out[k])[g] = o;
    }
  }
}

}  // namespace

// extra0..4 are operands the variant passes and the kernel never reads, as
// are starts, counts, meta_rows, meta_zmin and recs where no flag reads
// them; any pointer may be null where its flag is off
extern "C" int dpvr_fill_tiles(void* color, void* depth, const void* x,
                               const void* order, const void* starts,
                               const void* counts, const void* meta_rows,
                               const void* meta_zmin, const void* recs,
                               const void* bidx, const void* extra0,
                               const void* extra1, const void* extra2,
                               const void* extra3, const void* extra4,
                               const int* params, void* stream) {
  FillPtrs p{static_cast<int*>(color), static_cast<float*>(depth),
             static_cast<const int*>(x), static_cast<const int*>(order),
             static_cast<const int*>(starts), static_cast<const int*>(counts),
             static_cast<const int*>(meta_rows),
             static_cast<const float*>(meta_zmin),
             static_cast<const int*>(recs), static_cast<const int*>(bidx),
             {extra0, extra1, extra2, extra3, extra4}};
  FillParams q{params[0], params[1], params[2], params[3], params[4],
               params[5], params[6], params[7], params[8], params[9],
               params[10], params[11], params[12]};
  const int blocks = params[13], threads = params[14], smem = params[15];
  if (threads != kFillThreads || blocks <= 0 || q.total <= 0 || q.n4 <= 0
      || smem < 0 || smem > kSmemDefault) {
    return (int)cudaErrorInvalidValue;
  }
  fill_tiles_kernel<<<blocks, kFillThreads, smem,
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
  const int blocks = params[5], threads = params[6];
  CopyParams q{params[3], params[4], rows * 32, {}, {}};
  for (int k = 0; k < kMaxIo; ++k) {
    q.mul[k] = params[7 + k];
    q.add[k] = params[7 + kMaxIo + k];
  }
  if (rows < 0 || block_rows <= 0 || rows % block_rows
      || threads != kCopyThreads
      || (long long)blocks * kCopyThreads < q.n4) {
    return (int)cudaErrorInvalidValue;
  }
  if (blocks > 0) {
    blocked_copy_kernel<<<blocks, kCopyThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(p, q);
  }
  return (int)cudaGetLastError();
}

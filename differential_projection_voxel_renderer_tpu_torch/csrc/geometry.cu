// K1: stage A of the frame -- differential projection and culling of the
// gathered quad stream, kVec consecutive quads a thread (stage_a.cuh
// holds the per-quad math, shared with K3).
//
// Replaces the TPU kernel `_geom_kernel` / `geom_block_compute` of
// differential_projection_voxel_renderer_tpu/ops/geometry_pallas.py.
//
// What bounds it on an H100: latency, then memory.  A quad reads 16 bytes
// (word + chunk origin) and writes 17, about 4.3 MB at the 131072-quad
// bucket and 1.6 MB at the 49152 one, one to a few microseconds of HBM
// time; the ~200 float operations a quad are far below the card's rate.
// The design: each block stages the camera and the stream range once in
// shared memory (stage_a.cuh stage_camera); each thread takes kVec
// consecutive quads with kVec-word loads (words, each chunk-origin row)
// and stores (bbx, bby, subpixel, depth_near; valid as one kVec-byte
// word), over a grid sized to the card's SMs with a grid-stride loop; a
// group that runs past the stream's end, or a stream whose arrays are not
// aligned to the group, takes its quads one by one.  The face axes come
// from the face bits in registers.  The two counts the step needs
// (sub-pixel total, valid count) are summed in the same launch, a warp
// reduction and one atomic a warp (stage_a.cuh count_warp), into slots
// the C entry zeroes first, so the step launches no reduction for them.
// kVec is 1 in the port: the stream fits the card in one wave at one quad
// a thread, and two or four a thread run their chains one after another
// on fewer warps (benches/k1_call.py --variants times the three).
//
// Span mode (flag kSpan, bit 4) runs a separate instance at one quad a
// thread: the same fields with the clip-normal backface test and no
// sub-pixel test, plus the four NDC rows of each quad's box (nx_min,
// nx_max, ny_min, ny_max) into ndc f32[4, gq], which span mode's records
// are built from.  It replaces the jnp form of stage A that the reference
// runs in span mode (rendering/pipeline.py `_render_step`, the Pallas
// kernel having no span form), and moves 16 more bytes a quad.
//
// Rounding contract: this file is compiled with -fmad=false (no
// multiply-add contraction), IEEE division (-prec-div=true) and no fast
// math; the per-quad math lives in stage_a.cuh, shared with kernel K3.

#include <string.h>

#include <atomic>

#include <type_traits>

#include "stage_a.cuh"

namespace {

constexpr int kK1Threads = 128;
constexpr int kK1BlocksPerSm = 16;  // the grid's cap, in blocks an SM

// flag bits 2-3: log2 of the quads a thread (0: one, 1: two, 2: four)
constexpr int kQuadsShift = 2;

// The access types of kVec consecutive words and bytes.
template <int kVec> struct Access;
template <> struct Access<1> {
  using I = int;
  using F = float;
  using B = unsigned char;
};
template <> struct Access<2> {
  using I = int2;
  using F = float2;
  using B = unsigned short;
};
template <> struct Access<4> {
  using I = int4;
  using F = float4;
  using B = unsigned;
};

// kVec words from p (aligned to kVec words) into a[].
template <int kVec, typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&a)[kVec]) {
  using V = typename std::conditional<std::is_same<T, int>::value,
                                      typename Access<kVec>::I,
                                      typename Access<kVec>::F>::type;
  const V v = *reinterpret_cast<const V*>(p);
  memcpy(a, &v, sizeof(V));
}

// a[] to kVec words at p (aligned to kVec words).
template <int kVec, typename T>
__device__ __forceinline__ void store_vec(T* p, const T (&a)[kVec]) {
  using V = typename std::conditional<std::is_same<T, int>::value,
                                      typename Access<kVec>::I,
                                      typename Access<kVec>::F>::type;
  V v;
  memcpy(&v, a, sizeof(V));
  *reinterpret_cast<V*>(p) = v;
}

// The inputs of group g (stream entries g * kVec ...): with vector loads
// when the group is whole and `vec`, else one by one (entries past the
// stream's end are zero and unused).
template <int kVec>
__device__ __forceinline__ void load_group(
    int g, int gq, bool vec, const int* __restrict__ quads,
    const float* __restrict__ wx, const float* __restrict__ wy,
    const float* __restrict__ wz, int (&q)[kVec], float (&x)[kVec],
    float (&y)[kVec], float (&z)[kVec]) {
  const int i0 = g * kVec;
  if (vec && i0 + kVec <= gq) {
    load_vec<kVec>(quads + i0, q);
    load_vec<kVec>(wx + i0, x);
    load_vec<kVec>(wy + i0, y);
    load_vec<kVec>(wz + i0, z);
    return;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const bool in = i0 + k < gq;
    q[k] = in ? quads[i0 + k] : 0;
    x[k] = in ? wx[i0 + k] : 0.0f;
    y[k] = in ? wy[i0 + k] : 0.0f;
    z[k] = in ? wz[i0 + k] : 0.0f;
  }
}

// kVec consecutive quads a thread over a grid-stride loop.  Each group's
// loads go out before the work that precedes it (the first group's before
// the camera's barrier), so the round trips to memory overlap.  The span
// instance (kSpanMode, kVec 1) also writes ndc f32[4, gq].
template <int kVec, bool kSpanMode>
__global__ void __launch_bounds__(kK1Threads) project_cull_kernel(
    const int* __restrict__ quads, const float* __restrict__ wx,
    const float* __restrict__ wy, const float* __restrict__ wz,
    const float* __restrict__ view_proj, const float* __restrict__ cam_pos,
    const int* __restrict__ n_quads_in, const int* __restrict__ skip_in,
    int gq, int width, int height, int flags, int vec, StageAOut o,
    float* __restrict__ ndc) {
  __shared__ StageACam c;
  const int n_groups = (gq + kVec - 1) / kVec;
  const int stride = gridDim.x * kK1Threads;
  int g = blockIdx.x * kK1Threads + threadIdx.x;
  int q[kVec];
  float x[kVec], y[kVec], z[kVec];
  if (g < n_groups) load_group<kVec>(g, gq, vec, quads, wx, wy, wz, q, x, y, z);
  stage_camera(&c, view_proj, cam_pos, n_quads_in, skip_in);
  int n_sub = 0, n_valid = 0;
  for (; g < n_groups; g += stride) {
    const int i0 = g * kVec;
    StageAResult r[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      r[k] = stage_a_math<kSpanMode>(i0 + k, q[k], x[k], y[k], z[k], c,
                                     width, height, flags);
    const bool whole = vec && i0 + kVec <= gq;
    if (whole) {
      int bbx[kVec], bby[kVec], sub[kVec];
      float dn[kVec];
      typename Access<kVec>::B valid = 0;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        bbx[k] = r[k].bbx;
        bby[k] = r[k].bby;
        sub[k] = r[k].subpixel;
        dn[k] = r[k].depth_near;
        valid |= (typename Access<kVec>::B)r[k].valid << (8 * k);  // LE
      }
      store_vec<kVec>(o.bbx + i0, bbx);
      store_vec<kVec>(o.bby + i0, bby);
      store_vec<kVec>(o.sub + i0, sub);
      store_vec<kVec>(o.dn + i0, dn);
      *reinterpret_cast<typename Access<kVec>::B*>(o.valid + i0) = valid;
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (i0 + k < gq) {
        if (!whole) store_stage_a(o, i0 + k, r[k]);
        if constexpr (kSpanMode) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ndc[(size_t)j * gq + i0 + k] = r[k].ndc[j];
        }
        n_sub += r[k].subpixel;
        n_valid += r[k].valid;
      }
    }
    if (g + stride < n_groups)
      load_group<kVec>(g + stride, gq, vec, quads, wx, wy, wz, q, x, y, z);
  }
  count_warp(o.counts, n_sub, n_valid);
}

// The current device's SM count, read once a device (threads that drive
// other cards call this at once).
int sm_count() {
  static std::atomic<int> counts[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  int n = counts[dev].load(std::memory_order_relaxed);
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    counts[dev].store(n, std::memory_order_relaxed);
  }
  return n > 0 ? n : 132;
}

}  // namespace

// Stage A over quads i32[gq] with chunk origins quad_world f32[3, gq]
// under the camera view_proj f32[16] and cam_pos f32[3]; n_quads and skip
// (null: none skipped) are device i32 scalars; flags holds kBackface and
// kSubpixelCulling, in bits 2-3 log2 of the quads a thread (0 is the
// port's choice; 1 and 2 are kept for benches/k1_call.py --variants), and
// kSpan (span mode: one quad a thread only, and ndc not null).
// Writes valid (bool), bbx, bby, sub (i32) and dn (f32),
// each [gq], counts i32[2] (subpix_total, valid_count), which it
// zeroes first on the same stream, and in span mode ndc f32[4, gq].
extern "C" int dpvr_project_cull(const void* quads, const void* quad_world,
                                 const void* view_proj, const void* cam_pos,
                                 const void* n_quads, const void* skip,
                                 int gq, int width, int height, int flags,
                                 void* valid, void* bbx, void* bby, void* dn,
                                 void* sub, void* counts, void* ndc,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(counts, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess || gq <= 0) return (int)err;
  const float* qw = static_cast<const float*>(quad_world);
  const float* wy = qw + gq;
  const float* wz = qw + 2 * (size_t)gq;
  const StageAOut o = {static_cast<unsigned char*>(valid),
                       static_cast<int*>(bbx), static_cast<int*>(bby),
                       static_cast<float*>(dn), static_cast<int*>(sub),
                       static_cast<int*>(counts)};
  const int log_vec = (flags >> kQuadsShift) & 3;
  const bool span = (flags & kSpan) != 0;
  if (log_vec > 2 || (span && (log_vec != 0 || ndc == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int n_vec = 1 << log_vec;
  const uintptr_t align = 4u * n_vec - 1;
  const int vec = ((reinterpret_cast<uintptr_t>(quads) |
                    reinterpret_cast<uintptr_t>(qw) |
                    reinterpret_cast<uintptr_t>(wy) |
                    reinterpret_cast<uintptr_t>(wz) |
                    reinterpret_cast<uintptr_t>(valid) |
                    reinterpret_cast<uintptr_t>(bbx) |
                    reinterpret_cast<uintptr_t>(bby) |
                    reinterpret_cast<uintptr_t>(dn) |
                    reinterpret_cast<uintptr_t>(sub)) & align) == 0;
  const int n_groups = (gq + n_vec - 1) / n_vec;
  int blocks = (n_groups + kK1Threads - 1) / kK1Threads;
  const int cap = sm_count() * kK1BlocksPerSm;
  if (blocks > cap) blocks = cap;
  auto kernel = span           ? project_cull_kernel<1, true>
                : log_vec == 0 ? project_cull_kernel<1, false>
                : log_vec == 1 ? project_cull_kernel<2, false>
                               : project_cull_kernel<4, false>;
  kernel<<<blocks, kK1Threads, 0, s>>>(
      static_cast<const int*>(quads), qw, wy, wz,
      static_cast<const float*>(view_proj),
      static_cast<const float*>(cam_pos), static_cast<const int*>(n_quads),
      static_cast<const int*>(skip), gq, width, height, flags, vec, o,
      static_cast<float*>(ndc));
  return (int)cudaGetLastError();
}

// The CUDA runtime's current device as this library's own (static) runtime
// sees it on the calling thread, or -1 on an error: it shows whether the
// device a caller sets through PyTorch is the one these entry points
// launch on.
extern "C" int dpvr_current_device() {
  int dev = -1;
  return cudaGetDevice(&dev) == cudaSuccess ? dev : -1;
}

// K1: stage A of the frame -- differential projection and culling of the
// gathered quad stream, one thread per quad (stage_a.cuh holds the math).
//
// Replaces the TPU kernel `_geom_kernel` / `geom_block_compute` of
// differential_projection_voxel_renderer_tpu/ops/geometry_pallas.py.
//
// What bounds it on an H100: memory.  A quad reads 16 bytes (word + chunk
// origin) and writes 17, about 4.3 MB at the 131072-quad bucket, a few
// microseconds of HBM time; the ~300 flops per quad are far below the
// card's rate.  The design therefore keeps everything per quad in
// registers, reads the camera and the stream length straight from the
// caller's device tensors (no host sync, no staging copy: one launch per
// call), and makes every load and store coalesced (structure-of-arrays,
// thread i touches element i).
//
// Rounding contract: this file is compiled with -fmad=false (no
// multiply-add contraction), IEEE division (-prec-div=true) and no fast
// math; the per-quad math lives in stage_a.cuh, shared with kernel K3.

#include "stage_a.cuh"

namespace {

__global__ void project_cull_kernel(
    const int* __restrict__ quads, const float* __restrict__ wx_in,
    const float* __restrict__ wy_in, const float* __restrict__ wz_in,
    const float* __restrict__ view_proj, const float* __restrict__ cam_pos,
    const int* __restrict__ n_quads_in, const int* __restrict__ skip_in,
    int gq, int width, int height, int backface,
    unsigned char* __restrict__ valid_out, int* __restrict__ bbx_out,
    int* __restrict__ bby_out, float* __restrict__ dn_out,
    int* __restrict__ sub_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= gq) return;
  stage_a_quad(i, quads, wx_in, wy_in, wz_in, view_proj, cam_pos,
               n_quads_in, skip_in, width, height, backface, valid_out,
               bbx_out, bby_out, dn_out, sub_out);
}

}  // namespace

// skip may be null (no quads skipped); valid is a bool (one byte) array
extern "C" int dpvr_project_cull(const void* quads, const void* quad_world,
                                 const void* view_proj, const void* cam_pos,
                                 const void* n_quads, const void* skip,
                                 int gq, int width, int height, int backface,
                                 void* valid, void* bbx, void* bby, void* dn,
                                 void* sub, void* stream) {
  const float* qw = static_cast<const float*>(quad_world);
  const int threads = 256;
  const int blocks = (gq + threads - 1) / threads;
  if (gq > 0) {
    project_cull_kernel<<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(quads), qw, qw + gq, qw + 2 * (size_t)gq,
        static_cast<const float*>(view_proj),
        static_cast<const float*>(cam_pos), static_cast<const int*>(n_quads),
        static_cast<const int*>(skip), gq, width, height, backface,
        static_cast<unsigned char*>(valid),
        static_cast<int*>(bbx), static_cast<int*>(bby),
        static_cast<float*>(dn), static_cast<int*>(sub));
  }
  return (int)cudaGetLastError();
}

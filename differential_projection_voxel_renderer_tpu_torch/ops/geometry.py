"""Kernel K1: stage A over the whole gather stream (csrc/geometry.cu).

Counterpart of ``differential_projection_voxel_renderer_tpu/ops/
geometry_pallas.py``.  ``project_cull`` launches the CUDA kernel for CUDA
tensors and runs its plain PyTorch twin (``project_cull_plain``, the same
``stage_a_fields`` math) for CPU tensors; on a CUDA tensor it never falls
back to the twin.  ``span_mode`` selects the kernel's span instance (the
reference runs stage A as jnp in span mode; here it stays a kernel) and
adds the NDC box the span records are built from.

A launch costs the host more than the card, so the wrapper keeps its
own work small: the checks read attributes only, and the five outputs and
the two counts are views of one fresh buffer (``kernel_outputs``, the one
place that lays it out: the C entry point takes a pointer to each).
"""

from __future__ import annotations

import torch

from .. import _build
from . import projection as proj_ops

# launches of the CUDA kernel (not of the twin); ``launches_span`` counts
# the span instance's among them (read from _build's registry)
__getattr__ = _build.module_counts(
    {"launches": "K1", "launches_span": "K1 span"}, __name__)

# the kernel's flag bits (csrc/stage_a.cuh kBackface, kSubpixelCulling,
# kSpan; bits 2-3 are the quads a thread)
BACKFACE = 1
SUBPIXEL = 2
SPAN = 16

# the rows of span mode's NDC box ``ndc`` f32[4, GQ]
NDC_ROWS = ("nx_min", "nx_max", "ny_min", "ny_max")

# consecutive quads a thread of K1 takes: 1, 2 or 4 (flag bits 2-3, their
# log2; csrc/geometry.cu).  One is the fastest at the port's stream sizes;
# benches/k1_call.py --variants times each.
QUADS_PER_THREAD = 1


def device_i32(x, device) -> torch.Tensor:
    """An int32 scalar on ``device``: the tensor itself when it is one, a
    fill (not a host-to-device copy) for a Python int."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32 and x.dim() == 0 and x.device == device:
            return x
        return x.to(device, torch.int32).reshape(())
    return torch.full((), int(x), dtype=torch.int32, device=device)


def _check(x, name: str, dtype, dev: int, numel: int) -> None:
    if (not isinstance(x, torch.Tensor) or x.dtype != dtype
            or x.get_device() != dev or x.numel() != numel
            or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                         f"{numel} elements on the quads' device")


def kernel_args(quads, quad_world, n_quads, view_proj, cam_pos) -> tuple:
    """Checked stage-A inputs of a launch (K1, or K3's next stream) as the
    C entry point takes them: the pointers of quads, quad_world, view_proj,
    cam_pos and n_quads (a device scalar).  Device, dtype, shape and
    contiguity are read from attributes, nothing is converted."""
    if (quads.dtype != torch.int32 or quads.dim() != 1
            or not quads.is_contiguous()):
        raise ValueError("quads must be a contiguous int32[GQ] tensor")
    gq, dev = quads.shape[0], quads.get_device()
    _check(quad_world, "quad_world", torch.float32, dev, 3 * gq)
    if quad_world.shape != (3, gq):
        raise ValueError("quad_world must be f32[3, GQ]")
    _check(view_proj, "view_proj", torch.float32, dev, 16)
    _check(cam_pos, "cam_pos", torch.float32, dev, 3)
    _check(n_quads, "n_quads", torch.int32, dev, 1)
    return (quads.data_ptr(), quad_world.data_ptr(), view_proj.data_ptr(),
            cam_pos.data_ptr(), n_quads.data_ptr())


def kernel_outputs(gq: int, device, span: bool = False
                   ) -> dict[str, torch.Tensor]:
    """The output dict of one launch over ``gq`` quads: views of one fresh
    i32 buffer holding bbx, bby, subpixel i32 and depth_near f32 (gq words
    each, so 16-byte aligned rows when gq is a multiple of 4), with
    ``span`` the NDC box ``ndc`` f32[4, gq] (rows nx_min, nx_max, ny_min,
    ny_max), valid as gq bytes in (gq + 3) // 4 words, then
    ``subpix_total`` and ``valid_count`` (adjacent i32 scalars).  Never
    cached: a carried or shared stage A is still read while the next one
    is written."""
    nv = (gq + 3) // 4
    nn = 4 * gq if span else 0
    buf = torch.empty(4 * gq + nn + nv + 2, dtype=torch.int32, device=device)
    bbx, bby, sub, dn, ndc, valid, counts = buf.split(
        (gq, gq, gq, gq, nn, nv, 2))
    valid = valid.view(torch.bool)
    subpix_total, valid_count = counts.unbind()
    out = dict(valid=valid if gq % 4 == 0 else valid[:gq], bbx=bbx,
               bby=bby, depth_near=dn.view(torch.float32), subpixel=sub,
               subpix_total=subpix_total, valid_count=valid_count)
    if span:
        out["ndc"] = ndc.view(torch.float32).view(4, gq)
    return out


def output_ptrs(out: dict) -> tuple:
    """The pointers the C entry points take for ``kernel_outputs``' dict:
    valid, bbx, bby, depth_near, subpixel and the two counts."""
    return (out["valid"].data_ptr(), out["bbx"].data_ptr(),
            out["bby"].data_ptr(), out["depth_near"].data_ptr(),
            out["subpixel"].data_ptr(), out["subpix_total"].data_ptr())


def project_cull_plain(quads, quad_world, n_quads, view_proj, cam_pos, *,
                       width: int, height: int, backface_culling: bool = True,
                       subpixel_culling: bool = True, skip_quads=0,
                       span_mode: bool = False):
    """Plain PyTorch twin of K1 with its signature and outputs."""
    dev = quads.device
    idx = torch.arange(quads.shape[0], dtype=torch.int32, device=dev)
    in_stream = ((idx < device_i32(n_quads, dev))
                 & (idx >= device_i32(skip_quads, dev)))
    qw = tuple(quad_world[a] for a in range(3))
    pr = proj_ops.stage_a_fields(
        proj_ops.decode_quads(quads), qw, in_stream,
        view_proj.to(dev, torch.float32).reshape(4, 4),
        cam_pos.to(dev, torch.float32).reshape(3), width=width,
        height=height, span_mode=span_mode,
        backface_culling=backface_culling,
        subpixel_culling=subpixel_culling)
    sub = pr["subpixel"].to(torch.int32)
    out = dict(valid=pr["valid"],
               bbx=pr["bb_x0"] | (pr["bb_x1"] << 16),
               bby=pr["bb_y0"] | (pr["bb_y1"] << 16),
               depth_near=pr["depth_near"], subpixel=sub,
               subpix_total=sub.sum(dtype=torch.int32),
               valid_count=pr["valid"].sum(dtype=torch.int32))
    if span_mode:
        out["ndc"] = torch.stack([pr[k] for k in NDC_ROWS])
    return out


def project_cull(quads, quad_world, n_quads, view_proj, cam_pos, *,
                 width: int, height: int, backface_culling: bool = True,
                 subpixel_culling: bool = True, skip_quads=0,
                 span_mode: bool = False):
    """Stage A over the gather stream.

    ``quads`` int32[GQ] words, ``quad_world`` f32[3, GQ] chunk origins,
    ``n_quads`` the stream length (a device scalar: no host sync),
    ``view_proj`` f32[4, 4], ``cam_pos`` f32[3]; on the card all of them
    contiguous on the quads' device.  Returns the dict of the reference's
    ``project_cull_pallas``: ``valid`` bool, ``bbx``/``bby`` (x0|x1<<16 /
    y0|y1<<16) i32, ``depth_near`` f32, ``subpixel`` i32, each [GQ]; and
    the sums ``subpix_total`` and ``valid_count`` (i32 scalars).  Without
    ``subpixel_culling`` no quad is sub-pixel and tiny quads stay
    valid.  ``span_mode``: the clip-normal backface test, no sub-pixel
    cull, and ``ndc`` f32[4, GQ], the NDC box (rows nx_min, nx_max,
    ny_min, ny_max)."""
    if quads.device.type != "cuda":
        return project_cull_plain(
            quads, quad_world, n_quads, view_proj, cam_pos, width=width,
            height=height, backface_culling=backface_culling,
            subpixel_culling=subpixel_culling, skip_quads=skip_quads,
            span_mode=span_mode)
    dev = quads.device
    # a Python int becomes a device scalar here, so that it outlives the
    # launch's enqueueing (not the step's case: it passes device scalars)
    n_quads = device_i32(n_quads, dev)
    args = kernel_args(quads, quad_world, n_quads, view_proj, cam_pos)
    skip = (None if isinstance(skip_quads, int) and skip_quads == 0
            else device_i32(skip_quads, dev))
    gq = quads.shape[0]
    out = kernel_outputs(gq, dev, span=span_mode)
    if span_mode:  # the span instance: one quad a thread
        flags = SPAN | (BACKFACE if backface_culling else 0)
    else:
        flags = ((BACKFACE if backface_culling else 0)
                 | (SUBPIXEL if subpixel_culling else 0)
                 | (QUADS_PER_THREAD.bit_length() - 1) << 2)
    # the raw handle of the current stream: torch.cuda.current_stream()
    # builds a Stream object on every call
    _build.launch(
        "dpvr_project_cull", dev.index, "project_cull",
        *args, None if skip is None else skip.data_ptr(), gq, width, height,
        flags, *output_ptrs(out),
        out["ndc"].data_ptr() if span_mode else None,
        torch._C._cuda_getCurrentRawStream(dev.index))
    _build.count("K1", dev.index, *(("K1 span",) if span_mode else ()))
    return out

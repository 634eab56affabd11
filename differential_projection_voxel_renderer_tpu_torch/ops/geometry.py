"""Kernel K1: stage A over the whole gather stream (csrc/geometry.cu).

Counterpart of ``differential_projection_voxel_renderer_tpu/ops/
geometry_pallas.py``.  ``project_cull`` launches the CUDA kernel for CUDA
tensors and runs its plain PyTorch twin (``project_cull_plain``, the same
``stage_a_fields`` math) for CPU tensors; on a CUDA tensor it never falls
back to the twin.
"""

from __future__ import annotations

import torch

from . import projection as proj_ops

# launches of the CUDA kernel (not of the twin)
launches = 0


def device_i32(x, device) -> torch.Tensor:
    """An int32 scalar on ``device``: a no-op for a device tensor, a fill
    (not a host-to-device copy) for a Python int."""
    if isinstance(x, torch.Tensor):
        return x.to(device, torch.int32).reshape(())
    return torch.full((), int(x), dtype=torch.int32, device=device)


def project_cull_plain(quads, quad_world, n_quads, view_proj, cam_pos, *,
                       width: int, height: int, backface_culling: bool = True,
                       skip_quads=0):
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
        height=height, backface_culling=backface_culling)
    return dict(valid=pr["valid"],
                bbx=pr["bb_x0"] | (pr["bb_x1"] << 16),
                bby=pr["bb_y0"] | (pr["bb_y1"] << 16),
                depth_near=pr["depth_near"],
                subpixel=pr["subpixel"].to(torch.int32))


def project_cull(quads, quad_world, n_quads, view_proj, cam_pos, *,
                 width: int, height: int, backface_culling: bool = True,
                 skip_quads=0):
    """Stage A over the gather stream (exact mode).

    ``quads`` int32[GQ] words, ``quad_world`` f32[3, GQ] chunk origins,
    ``n_quads`` the stream length (a device scalar: no host sync),
    ``view_proj`` f32[4, 4], ``cam_pos`` f32[3].  Returns the dict of the
    reference's ``project_cull_pallas``: ``valid`` bool, ``bbx``/``bby``
    (x0|x1<<16 / y0|y1<<16) i32, ``depth_near`` f32, ``subpixel`` i32, each
    [GQ]."""
    if quads.device.type != "cuda":
        return project_cull_plain(
            quads, quad_world, n_quads, view_proj, cam_pos, width=width,
            height=height, backface_culling=backface_culling,
            skip_quads=skip_quads)
    global launches
    from .. import _build

    gq = quads.shape[0]
    dev = quads.device
    if quads.dtype != torch.int32 or not quads.is_contiguous():
        raise ValueError("quads must be a contiguous int32 tensor")
    qw = quad_world
    if (not isinstance(qw, torch.Tensor) or qw.shape != (3, gq)
            or qw.dtype != torch.float32 or qw.device != dev):
        raise ValueError("quad_world must be f32[3, GQ] on the quads' device")
    qw = qw.contiguous()
    vp = view_proj.to(dev, torch.float32).contiguous()
    cam = cam_pos.to(dev, torch.float32).contiguous()
    nq = device_i32(n_quads, dev)
    skip = (None if isinstance(skip_quads, int) and skip_quads == 0
            else device_i32(skip_quads, dev))
    valid = torch.empty(gq, dtype=torch.bool, device=dev)
    bbx = torch.empty(gq, dtype=torch.int32, device=dev)
    bby = torch.empty(gq, dtype=torch.int32, device=dev)
    dn = torch.empty(gq, dtype=torch.float32, device=dev)
    sub = torch.empty(gq, dtype=torch.int32, device=dev)
    err = _build.lib().dpvr_project_cull(
        quads.data_ptr(), qw.data_ptr(), vp.data_ptr(), cam.data_ptr(),
        nq.data_ptr(), None if skip is None else skip.data_ptr(),
        gq, width, height, int(backface_culling), valid.data_ptr(),
        bbx.data_ptr(), bby.data_ptr(), dn.data_ptr(), sub.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "project_cull")
    launches += 1
    return dict(valid=valid, bbx=bbx, bby=bby, depth_near=dn, subpixel=sub)

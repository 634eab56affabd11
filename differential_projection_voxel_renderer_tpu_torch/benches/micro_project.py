"""Stage A's sub-stages on the card, then stage A as kernel K1.

The counterpart of ``benches/micro_project.py``, with the loop discipline
of benches/profile_stages.py: K iterations (``PROF_K``, default 30), each
with its own jittered camera, captured in one CUDA graph.  The sub-stages
are K1's plain PyTorch version (``ops/projection.stage_a_fields``) cut
short -- ``decode`` (the quad words' fields), ``basis`` (+ the per-quad
clip-space basis), ``ws`` (+ the four corners' w), ``invs`` (+ their
reciprocals), ``ndc`` (+ the corners' NDC) -- as torch ops on the card;
``project`` is K1 (``ops/geometry.project_cull``) on the same stream.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.micro_project [--pose start|N]

Prints ``<sub-stage>: <ms> ms`` a line to stderr, as the original does.
``PROF_GQ`` keeps the stream's first entries.
"""

from __future__ import annotations

import os
import sys

import torch

from ..ops import geometry as geom_ops
from ..ops import projection as proj_ops
from . import scene as scene_mod
from .common import need_card
from .profile_stages import stage_ms

SUB_STAGES = ("decode", "basis", "ws", "invs", "ndc")
log = scene_mod.log


def make_sub_stages(quads, qw, n_quads, *, width: int, height: int):
    """{name: body(vp, cam) -> a small tensor} for the sub-stages and
    ``project``, on the stream's device."""
    wq = (qw[0], qw[1], qw[2])

    def sub(upto):
        def f(vp, cam):
            dec = proj_ops.decode_quads(quads)
            if upto == "decode":
                return (dec["u0"].sum() + dec["axis_pos"].sum()
                        + dec["face"].sum())
            basis = proj_ops._Basis(dec, wq, vp)
            if upto == "basis":
                return sum(x.sum() for x in basis.o + basis.t + basis.b)
            u0, u1, v0, v1 = dec["u0"], dec["u1"], dec["v0"], dec["v1"]
            corners_uv = ((u0, v0), (u1, v0), (u0, v1), (u1, v1))
            ws = [basis.corner(u, v, 3) for (u, v) in corners_uv]
            if upto == "ws":
                return sum(w.sum() for w in ws)
            invs = [torch.reciprocal(torch.where(w.abs() > 1e-30, w, 1e-30))
                    for w in ws]
            if upto == "invs":
                return sum(w.sum() for w in invs)
            acc = 0.0
            for r in range(3):
                acc = acc + sum((basis.corner(u, v, r) * inv).sum()
                                for (u, v), inv in zip(corners_uv, invs))
            return acc
        return f

    def project(vp, cam):
        ga = geom_ops.project_cull(quads, qw, n_quads, vp, cam, width=width,
                                   height=height)
        return ga["valid_count"] + ga["bbx"][0]

    return dict({s: sub(s) for s in SUB_STAGES}, project=project)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    pose = "start"
    if "--pose" in argv:
        pose = argv[argv.index("--pose") + 1]
        pose = pose if pose == "start" else int(pose)
    need_card()
    k = int(os.environ.get("PROF_K", "30"))
    sc = scene_mod.get_scene(pose=pose)
    quads, qw, n_quads, _, _ = scene_mod.scene_tensors(
        sc, "cuda", int(os.environ.get("PROF_GQ", "0")))
    log(f"scene: {int(n_quads)} quads (cap {quads.shape[0]}), "
        f"{torch.cuda.get_device_name(0)}")
    vps_np, cams_np = scene_mod.jittered_cameras(sc[3], sc[4], k)
    vps = torch.from_numpy(vps_np).cuda()
    cams = torch.from_numpy(cams_np).cuda()
    bodies = make_sub_stages(quads, qw, n_quads, width=scene_mod.WIDTH,
                             height=scene_mod.HEIGHT)
    for name, body in bodies.items():
        ms = stage_ms(body, vps, cams)
        log(f"{name:>12}: {ms:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())

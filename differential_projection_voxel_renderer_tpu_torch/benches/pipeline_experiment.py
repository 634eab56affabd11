"""Frames in flight against the serial step, on the card.

The counterpart of ``benches/pipeline_experiment.py``.  Each variant
renders K frames (``PROF_K``, default 30) of the benches' scene, each with
its own jittered camera (benches/scene.py), captured in one CUDA graph;
its time is the median over 5 replays of the graph's CUDA-event time,
over K (benches/common.py ``graph_ms``).  The variants:

  base     -- the serial step (``render_step``: K1, then the mid stages
              and K2, a frame)
  pipe     -- one stage later: frame i-1's mid stages and K2 from its
              carried stage A (``pre_geom``), then frame i's stage A as its
              own K1 launch
  pipedep  -- the same launch order as ``pipe``.  The original forced
              frame i's stage A after frame i-1's raster with a data
              dependency, which its scheduler could otherwise reorder; on
              one CUDA stream the launches already run in that order, so
              the variant keeps its label and measures ``pipe`` again
  fused    -- frame i's stage A inside frame i-1's raster launch (kernel
              K3, ``next_geom``)

Every variant renders the same frames; the last one's is checked against
the serial step's bit for bit, and a variant that differs raises.  The
original ran each variant in a process of its own, because its TPU slowed
in a long process; the port runs them in one.  Its ``wall*`` variants
measured how its remote TPU accepted calls and are not ported.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.pipeline_experiment [base|pipe|pipedep|fused ...]

One JSON line a variant to stdout, ``{"stage": ..., "ms": ...}``.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from ..ops import geometry as geom_ops
from ..ops import projection as proj_ops
from ..ops.shading import build_quad_color_tables
from ..ops.texture import TextureAtlas
from ..rendering import pipeline
from . import scene as scene_mod
from .common import graph_ms, need_card

VARIANTS = ("base", "pipe", "pipedep", "fused")
DEFAULT = ("base", "pipe", "pipedep")
log = scene_mod.log


def make_variants(quads, qw, n_quads, vps, cams, *, step_kw):
    """{variant: fn() -> the last frame's (color, depth, stats)}, each
    rendering every camera of (vps, cams) once."""
    k = vps.shape[0]
    width, height = step_kw["width"], step_kw["height"]

    def step(i, **kw):
        return pipeline.render_step(quads, qw, n_quads, vps[i], cams[i],
                                    **step_kw, **kw)

    def geom(i):
        return pipeline._pre_geom_of(geom_ops.project_cull(
            quads, qw, n_quads, vps[i], cams[i], width=width, height=height))

    def base():
        out = None
        for i in range(k):
            out = step(i)
        return out

    def pipe():
        pre = geom(0)
        for i in range(1, k):
            step(i - 1, pre_geom=pre)
            pre = geom(i)
        return step(k - 1, pre_geom=pre)

    def fused():
        pre = geom(0)
        for i in range(1, k):
            *_, pre = step(i - 1, pre_geom=pre, next_geom=(
                quads, qw, n_quads, vps[i], cams[i]))
        return step(k - 1, pre_geom=pre)

    return dict(base=base, pipe=pipe, pipedep=pipe, fused=fused)


def same_frame(a, b) -> bool:
    """Two (color, depth, stats) equal bit for bit."""
    return (torch.equal(a[0], b[0]) and torch.equal(
        a[1].view(torch.int32), b[1].view(torch.int32))
        and torch.equal(a[2], b[2]))


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    variants = argv or list(DEFAULT)
    for v in variants:
        if v not in VARIANTS:
            raise ValueError(f"unknown variant {v!r}; the variants are "
                             f"{VARIANTS}")
    need_card()
    k = int(os.environ.get("PROF_K", "30"))
    sc = scene_mod.get_scene()
    quads, qw, n_quads, _, _ = scene_mod.scene_tensors(sc, "cuda")
    log(f"scene: {int(n_quads)} quads (cap {quads.shape[0]}), "
        f"{torch.cuda.get_device_name(0)}")
    gq = quads.shape[0]
    step_kw = dict(
        color_tables=proj_ops.color_table_tensors(
            build_quad_color_tables(TextureAtlas().kernel_tables()), "cuda"),
        width=scene_mod.WIDTH, height=scene_mod.HEIGHT, tile_h=16,
        tile_w=128, render_cap=min(49152, gq), tile_k_cap=98304)
    vps_np, cams_np = scene_mod.jittered_cameras(sc[3], sc[4], k)
    vps = torch.from_numpy(vps_np).cuda()
    cams = torch.from_numpy(cams_np).cuda()
    fns = make_variants(quads, qw, n_quads, vps, cams, step_kw=step_kw)
    ref = pipeline.render_step(quads, qw, n_quads, vps[k - 1], cams[k - 1],
                               **step_kw)
    for v in variants:
        if not same_frame(fns[v](), ref):
            raise AssertionError(f"{v}: the last frame differs from the "
                                 f"serial step's")
        ms = graph_ms(fns[v], calls=1, reps=5) / k
        log(f"{v}: {ms:.3f} ms/frame")
        print(json.dumps({"stage": v, "ms": round(ms, 4)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

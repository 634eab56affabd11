"""Stage-level device times of the render step on the card.

The counterpart of ``benches/profile_stages.py``.  Each stage runs K
iterations (``PROF_K``, default 30), each with its own jittered camera
(benches/scene.py ``jittered_cameras``), captured in one CUDA graph; a
stage's time is the median over 5 replays of the graph's CUDA-event time,
over K (benches/common.py ``graph_ms``).  The stages, on the benches'
1280x720 vd12 scene (``--pose``: the start pose, or key N of
``app/flythrough.default_path(24)``):

  project   -- stage A on the full gather stream (kernel K1)
  compact   -- + the survivor sort and the multi-row gather
  coeffs    -- + the rasterizer coefficients and the record stacking
  bin       -- + the tile binning (sort) and stage 5, the record gather
               and the per-octet metadata (the tile_meta kernel)
  raster    -- K2 alone on the step's records
  raster0   -- K2 with every tile empty (its per-tile fixed cost)
  full      -- the whole step (``rendering.pipeline.render_step``)

and the packed probe: ``pbin`` (the packed step up to ``build_bin_lists``
and its per-bin metadata), ``pbin1`` (up to the binning), ``pbin2`` (up
to the record gather), and ``praster`` (K4 alone on the packed step's
records; the original's ``raster`` stage reaches the packed kernel when
the records carry per-bin metadata).

    python -m differential_projection_voxel_renderer_tpu_torch.benches.profile_stages [--pose start|N] [stage ...]

One JSON line a stage to stdout, ``{"stage": ..., "ms": ...}``;
diagnostics to stderr.  ``PROF_GQ`` keeps the stream's first entries,
``PROF_RC`` and ``PROF_TK`` set the render and item caps.  The
original's TPU knobs -- the ``_tpsN``, ``_opiN``, ``_sgN``, ``_bqN`` and
``_rt`` suffixes, the pair-row stage ``_pr`` (``DPVR_PAIR_ROWS``) and the
tile shape ``PROF_TH``/``PROF_TW`` -- have no meaning for K2 on Hopper
(ROADMAP.md, "not ported, by design"): a stage or setting that names one
raises.
"""

from __future__ import annotations

import json
import os
import sys

import torch

from ..ops import geometry as geom_ops
from ..ops import projection as proj_ops
from ..ops import raster as raster_ops
from ..ops import raster_packed as packed_ops
from ..ops.shading import build_quad_color_tables
from ..ops.texture import TextureAtlas
from ..rendering import pipeline
from . import scene as scene_mod
from .common import graph_ms, need_card

STAGES = ("project", "compact", "coeffs", "bin", "raster", "raster0",
          "full")
PACKED_STAGES = ("pbin", "pbin1", "pbin2", "praster")
# the original's stage suffixes and settings that tune the TPU kernel
TPU_SUFFIXES = ("_tps", "_opi", "_sg", "_bq", "_rt", "_pr")
TPU_ENV = ("PROF_TH", "PROF_TW", "DPVR_PAIR_ROWS")
TILE_H, TILE_W = 16, 128
NOT_PORTED = ("names a TPU knob of the original bench, which the port "
              "leaves out by design (ROADMAP.md, 'Not ported, by design': "
              "the TPU knobs)")

log = scene_mod.log


def check_stage(name: str) -> str:
    """``name`` if it is a stage of this bench; raises ValueError if it
    carries a TPU knob suffix or is unknown."""
    if any(s in name for s in TPU_SUFFIXES):
        raise ValueError(f"stage {name!r} {NOT_PORTED}")
    if name not in STAGES + PACKED_STAGES:
        raise ValueError(f"unknown stage {name!r}; the stages are "
                         f"{STAGES + PACKED_STAGES}")
    return name


def check_env(environ=os.environ) -> None:
    """Raise if a TPU knob of the original is set."""
    for k in TPU_ENV:
        if k in environ:
            raise ValueError(f"{k} {NOT_PORTED}")


def make_stages(quads, qw, n_quads, *, width: int, height: int, tables,
                rc: int, tk: int, vp0, cam0):
    """{stage: body(vp, cam) -> a small tensor}, each the step up to that
    stage on the stream (quads, qw, n_quads) for one camera; ``raster``,
    ``raster0`` and ``praster`` take the records of the camera (vp0, cam0)
    and ignore theirs.  The bodies run on the stream's device."""
    gq = quads.shape[0]
    dev = quads.device
    rc = min(rc, gq)
    out_h = -height % TILE_H + height
    tiles_y, tiles_x = out_h // TILE_H, width // TILE_W
    i32 = torch.int32
    step_kw = dict(color_tables=tables, width=width, height=height,
                   tile_h=TILE_H, tile_w=TILE_W, render_cap=rc,
                   tile_k_cap=tk)
    stream_q = torch.arange(gq, dtype=i32, device=dev)

    def project(vp, cam):
        ga = geom_ops.project_cull(quads, qw, n_quads, vp, cam, width=width,
                                   height=height)
        return ga["valid_count"] + ga["bbx"][0]

    def through(upto):
        def f(vp, cam):
            ga = geom_ops.project_cull(quads, qw, n_quads, vp, cam,
                                       width=width, height=height)
            count_c = torch.clamp(ga["valid_count"], max=rc)
            idx = torch.sort(torch.where(ga["valid"], stream_q,
                                         2**30)).values[:rc]
            idx = torch.clamp(idx, max=gq - 1).long()
            pre = torch.stack([quads, qw[0].view(i32), qw[1].view(i32),
                               qw[2].view(i32), ga["bbx"], ga["bby"],
                               ga["depth_near"].view(i32)])[:, idx]
            if upto == "compact":
                return pre[:, 0]
            quads_c = pre[0]
            wq_c = tuple(pre[1 + a].view(torch.float32) for a in range(3))
            bbx_c, bby_c = pre[4], pre[5]
            dn_c = pre[6].view(torch.float32)
            coeffs = proj_ops.quad_coefficients(quads_c, wq_c, vp, tables)
            all22 = torch.stack(
                [coeffs[k].view(i32) for k in raster_ops.F_FIELDS]
                + [coeffs[k] for k in raster_ops.I_FIELDS] + [bby_c,
                                                              pre[6]])
            if upto == "coeffs":
                return all22[:, 0]
            tilebox = proj_ops.pack_tilebox(
                bbx_c & 0xFFFF, bbx_c >> 16, bby_c & 0xFFFF, bby_c >> 16,
                tile_h=TILE_H, tile_w=TILE_W)
            dq4 = pipeline._depth_class(dn_c)
            y0_c = bby_c & 0xFFFF
            band = torch.clamp(torch.clamp(
                y0_c - (y0_c // TILE_H) * TILE_H, 0, TILE_H - 1) >> 2, max=3)
            flat, t_of_item, starts, counts, ovf = (
                raster_ops.build_tile_lists(
                    tilebox, count_c, (dq4 << 2) | band, dq4 << 2,
                    tiles_y=tiles_y, tiles_x=tiles_x, item_cap=tk))
            _, rows, _ = raster_ops.tile_metadata(
                all22, flat, t_of_item, starts, counts, tiles_y=tiles_y,
                tiles_x=tiles_x, tile_h=TILE_H)
            return rows[:1] + starts[-1] + counts[-1] + ovf
        return f

    def full(vp, cam):
        c, d, s = pipeline.render_step(quads, qw, n_quads, vp, cam,
                                       **step_kw)
        return c[0, 0] + s[1]

    def packed(mode):
        def f(vp, cam):
            outs = pipeline.render_step(quads, qw, n_quads, vp, cam,
                                        packed_raster=True,
                                        debug_return_records=mode, **step_kw)
            return outs[0].reshape(-1)[:1]
        return f

    rec = pipeline.render_step(quads, qw, n_quads, vp0, cam0,
                               debug_return_records=True, **step_kw)
    rec0 = (rec[0], torch.zeros_like(rec[1]), torch.zeros_like(rec[2]),
            *rec[3:])
    recp = pipeline.render_step(quads, qw, n_quads, vp0, cam0,
                                packed_raster=True,
                                debug_return_records=True, **step_kw)
    rkw = dict(height=height, width=width, tile_h=TILE_H, tile_w=TILE_W,
               out_h=out_h)

    def raster(records):
        def f(vp, cam):
            return raster_ops.rasterize_tiles(*records, **rkw)[0][0, :1]
        return f

    def praster(vp, cam):
        return packed_ops.rasterize_packed(
            *recp, height=height, width=width, out_h=out_h)[0][0, :1]

    return dict(project=project, compact=through("compact"),
                coeffs=through("coeffs"), bin=through("bin"),
                raster=raster(rec), raster0=raster(rec0), full=full,
                pbin=packed(True), pbin1=packed("bin"),
                pbin2=packed("gather"), praster=praster), rec, recp


def stage_ms(body, vps, cams, reps: int = 5) -> float:
    """Device ms an iteration: ``body(vps[i], cams[i])`` for every i,
    captured in one CUDA graph, the median over ``reps`` replays between
    CUDA events (benches/common.py ``graph_ms``), over the iterations."""
    k = vps.shape[0]

    def loop():
        for i in range(k):
            body(vps[i], cams[i])

    return graph_ms(loop, calls=1, reps=reps) / k


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    pose = "start"
    if "--pose" in argv:
        i = argv.index("--pose")
        pose = argv[i + 1]
        del argv[i:i + 2]
        pose = pose if pose == "start" else int(pose)
    stages = [check_stage(s) for s in argv] or list(STAGES)
    check_env()
    need_card()
    k = int(os.environ.get("PROF_K", "30"))
    sc = scene_mod.get_scene(pose=pose)
    quads, qw, n_quads, vp, cam = scene_mod.scene_tensors(
        sc, "cuda", int(os.environ.get("PROF_GQ", "0")))
    log(f"scene ({scene_mod.pose_name(pose)}): {int(n_quads)} quads "
        f"gathered (cap {quads.shape[0]}), {torch.cuda.get_device_name(0)}")
    tables = proj_ops.color_table_tensors(
        build_quad_color_tables(TextureAtlas().kernel_tables()), "cuda")
    bodies, rec, recp = make_stages(
        quads, qw, n_quads, width=scene_mod.WIDTH, height=scene_mod.HEIGHT,
        tables=tables, rc=int(os.environ.get("PROF_RC", "49152")),
        tk=int(os.environ.get("PROF_TK", "98304")), vp0=vp, cam0=cam)
    vps_np, cams_np = scene_mod.jittered_cameras(sc[3], sc[4], k)
    vps = torch.from_numpy(vps_np).cuda()
    cams = torch.from_numpy(cams_np).cuda()
    for st in stages:
        if st in ("raster", "raster0"):
            counts = rec[2] if st == "raster" else torch.zeros_like(rec[2])
            log(f"{st}: {int(counts.sum())} binned items over "
                f"{int((counts > 0).sum())} tiles")
        elif st == "praster":
            log(f"{st}: {int(recp[2].sum())} binned items over "
                f"{int((recp[2] > 0).sum())} bins")
        ms = stage_ms(bodies[st], vps, cams)
        log(f"{st:>10}: {ms:.3f} ms")
        print(json.dumps({"stage": st, "ms": round(ms, 4)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Where a streaming flythrough frame's host time goes, on the card.

The counterpart of ``benches/fly_profile.py``: the flythrough_bench's
engine and warm-ups (without the resident mode), pass 1 of its flight to
move the camera into streaming territory, then pass 2 with
``render_frame``'s phases timed apart: ``world_update`` (chunk
generation), ``remesh_mesh_upload`` (the visibility query, the remesh
scan, meshing and the pool insert, and the pool's retain), and
``funnel_plus_render`` (the rest of the frame: its funnel and the render
call, with the card synchronised at the pass's end).  With
``DPVR_SPLIT_MESH=1`` the remesh splits into ``remesh_scan``,
``remesh_mesh_only`` and ``remesh_insert``; ``DPVR_DEVICE_MESHING=1``
meshes remesh batches on the card (``Engine.device_meshing``).

    python -m differential_projection_voxel_renderer_tpu_torch.benches.fly_profile [--vd VD] [--frames N]

One JSON line a section to stdout, ``{"section": ..., "ms_per_frame":
...}``, then ``wall_total`` and ``chunks_meshed_per_frame``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..meshing.greedy import mesh_chunk
from .common import need_card
from .flythrough_bench import STEP, YAW_STEP, flight, warmed_engine


def split_remesh(eng, vis_pos):
    """``Engine._remesh_positions`` in three timed parts: (chunks to mesh,
    scan seconds, mesh seconds, insert seconds)."""
    ts = time.perf_counter()
    _, has = eng.pool.lookup_slots(vis_pos)
    to_mesh = []
    if not has.all():
        meshed = eng.pool.by_pos
        loaded = eng.world.chunks
        for p in vis_pos[~has].tolist():
            pos = (p[0], p[1], p[2])
            to_mesh.append(pos)
            for off in eng._neighbor_offsets:
                np_ = (pos[0] + off[0], pos[1] + off[1], pos[2] + off[2])
                if np_ in loaded and np_ in meshed:
                    to_mesh.append(np_)
    tm = time.perf_counter()
    batch = []
    for pos in sorted(set(to_mesh)):
        chunk = eng.world.chunks.get(pos)
        if chunk is not None:
            batch.append((pos, mesh_chunk(chunk, eng.world.chunks)))
    ti = time.perf_counter()
    eng.pool.insert_many(batch)
    return len(to_mesh), tm - ts, ti - tm, time.perf_counter() - ti


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vd", type=int, default=12)
    ap.add_argument("--frames", type=int, default=40)
    a = ap.parse_args(argv)
    need_card()
    if os.environ.get("DPVR_RESIDENT"):
        raise ValueError("fly_profile times the serial frame's phases; "
                         "unset DPVR_RESIDENT")
    eng = warmed_engine(a.vd, pipelined=False)
    if os.environ.get("DPVR_DEVICE_MESHING"):
        eng.device_meshing = True
    split = bool(os.environ.get("DPVR_SPLIT_MESH"))
    flight(eng, a.frames, pipelined=False)

    n = a.frames
    t_update = t_remesh = t_rest = 0.0
    t_scan = t_mesh = t_insert = 0.0
    chunks_meshed = 0
    torch.cuda.synchronize()
    t_all0 = time.perf_counter()
    for _ in range(n):
        eng.camera.position += STEP
        eng.camera.yaw += YAW_STEP
        cam = eng.camera
        t0 = time.perf_counter()
        eng.world.update(cam.position)
        t1 = time.perf_counter()
        vis_pos = eng.world.get_visible_positions(cam.position,
                                                  cam.extract_frustum())
        if split:
            k, s, m, i = split_remesh(eng, vis_pos)
            chunks_meshed += k
            t_scan, t_mesh, t_insert = t_scan + s, t_mesh + m, t_insert + i
        else:
            chunks_meshed += eng._remesh_positions(vis_pos)
        eng.pool.retain(eng.world.chunks)
        t2 = time.perf_counter()
        # the frame through the normal path: the world and the pool are
        # settled for this camera, so its funnel finds nothing to mesh
        eng.render_frame(dt=0.0)
        t3 = time.perf_counter()
        t_update += t1 - t0
        t_remesh += t2 - t1
        t_rest += t3 - t2
    torch.cuda.synchronize()
    t_rest += time.perf_counter() - t3
    wall = time.perf_counter() - t_all0

    def emit(name, sec):
        print(json.dumps({"section": name,
                          "ms_per_frame": round(sec / n * 1000, 3)}),
              flush=True)

    emit("world_update", t_update)
    emit("remesh_mesh_upload", t_remesh)
    if split:
        emit("remesh_scan", t_scan)
        emit("remesh_mesh_only", t_mesh)
        emit("remesh_insert", t_insert)
    emit("funnel_plus_render", t_rest)
    emit("wall_total", wall)
    print(json.dumps({"section": "chunks_meshed_per_frame",
                      "ms_per_frame": round(chunks_meshed / n, 2)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

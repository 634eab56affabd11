"""The reference's six cargo-bench targets, on the port.

The counterpart of ``benches/run_benches.py`` (SURVEY.md section 6):

- meshing:     uniform / terrain / dense / multi-chunk, the host mesher
- world:       generation sizes and the visibility query
- microbench:  the funnel counters per voxel pattern
- rendering:   the host framebuffer's clear, a single solid chunk at
               256x256 and a 3x3 terrain world at 1280x720, each as one
               CUDA graph of 20 steps (``rendering.pipeline.
               make_repeated_step``) and as 20 separate ``render_prepared``
               calls
- with ``--device``: differential projection (kernel K1,
  ``ops/geometry.project_cull``, on 131072 random quads whose origins come
  from per-chunk tables, with ``ops/projection.chunk_clip_origins`` of the
  same chunks), the device mesher (``ops/meshing_device``) on a 4x4
  terrain batch, and the span walker's frame: a span-mode step at
  1920x1080 and an exact one at 1280x720, each one CUDA graph of 20 steps
  (K1's span instance or K1, and K2).

The host cases run on the host; the rendering and device cases need the
card.  Host times are the host clock's mean over n calls after one
warm-up; device times are CUDA events around a graph replay, or around 20
calls in a row.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.run_benches [--device] [--quick]

``--quick`` runs the first case of each section.  Prints one line a case,
``<name>: <ms> ms (<rate> <unit>/s)``, under a ``== <section> ==`` line.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
import time

import numpy as np
import torch

from ..meshing.greedy import mesh_chunk
from ..models.camera import Camera
from ..models.chunk import Chunk
from ..models.world import World, WorldConfig
from ..ops import geometry as geom_ops
from ..ops import meshing_device as MD
from ..ops import projection as P
from ..rendering.framebuffer import Framebuffer
from ..rendering.pipeline import Renderer, make_repeated_step
from ..utils.config import RenderConfig
from .common import median_ms, need_card

QUICK = False


def timeit(name, fn, n=10, unit="", per=1):
    """The host clock's mean over ``n`` calls of ``fn`` after one warm-up;
    prints and returns the last result."""
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    dt = (time.perf_counter() - t0) / n
    rate = f" ({per / dt:,.0f} {unit}/s)" if unit else ""
    print(f"{name}: {dt * 1e3:.3f} ms{rate}", flush=True)
    return out


def cases(items):
    """All of ``items``, or its first with ``--quick``."""
    return items[:1] if QUICK else items


def bench_meshing():
    print("== meshing (host, native greedy) ==")
    terrain = Chunk.generate_terrain((0, 0, 0))
    solid = Chunk.generate_test_solid((1, 0, 0))
    rng = np.random.default_rng(0)
    dense = Chunk.varied((2, 0, 0), np.where(
        rng.random((32, 32, 32)) < 0.3, rng.integers(1, 4, (32, 32, 32)), 0
    ).astype(np.uint8))
    region = [Chunk.generate_terrain((x, 0, z)) for x in range(3)
              for z in range(3)]
    for name, fn, n, per in cases([
            ("terrain chunk", lambda: mesh_chunk(terrain), 50, 1),
            ("solid chunk", lambda: mesh_chunk(solid), 50, 1),
            ("dense random chunk", lambda: mesh_chunk(dense), 20, 1),
            ("3x3 region (9 chunks, neighbors)",
             lambda: [mesh_chunk(c, region) for c in region], 5, 9)]):
        timeit(name, fn, n=n, unit="chunk", per=per)


def bench_world():
    print("== world ==")
    for vd in cases([5, 10]):
        def gen(vd=vd):
            w = World(WorldConfig(view_distance=vd,
                                  max_chunks_per_frame=10**9))
            w.update(np.zeros(3))
            return w
        timeit(f"generate view sphere vd={vd}", gen, n=2, unit="chunk",
               per=len(gen().chunks))
    if QUICK:
        return
    w = World(WorldConfig(view_distance=10))
    w.update(np.zeros(3))
    cam = Camera(np.zeros(3), 16 / 9)
    fr = cam.extract_frustum()
    timeit("visibility query (sphere+frustum)",
           lambda: w.get_visible_chunks_frustum(np.zeros(3), fr), n=50)


def bench_microbench():
    """The funnel counters per voxel pattern (the reference's
    microbench: empty / full / checkerboard / sparse)."""
    os.environ["DPVR_PROFILING"] = "1"
    from ..utils import profiling

    importlib.reload(profiling)
    print("== microbench (funnel counters per pattern) ==")
    rng = np.random.default_rng(0)
    xyz = np.indices((32, 32, 32)).sum(0)
    patterns = {
        "empty": np.zeros((32, 32, 32), np.uint8),
        "full": np.full((32, 32, 32), 3, np.uint8),
        "checkerboard": ((xyz % 2) * 2).astype(np.uint8),
        "sparse": np.where(rng.random((32, 32, 32)) < 0.05, 1,
                           0).astype(np.uint8),
    }
    for name, blocks in cases(list(patterns.items())):
        c = Chunk.varied((0, 0, 0), blocks)
        t0 = time.perf_counter()
        q = mesh_chunk(c)
        dt = (time.perf_counter() - t0) * 1000
        nq = 0 if q is None else len(q)
        print(f"{name:13s}: {nq:6d} quads  {dt:7.3f} ms", flush=True)


def upload_pool(r: Renderer, chunks, vcap: int):
    """The chunks' meshes in a [vcap, 4096] pool on the renderer's device,
    one a slot, and their draw list: (pool, visible slots, counts,
    positions, chunks placed)."""
    pool = np.zeros((vcap, 4096), np.uint32)
    counts = np.zeros(vcap, np.int32)
    pos = np.zeros((vcap, 3), np.int32)
    vis = np.zeros(vcap, np.int32)
    n = 0
    for c in chunks:
        q = mesh_chunk(c, chunks)
        if q is None or n == vcap:
            continue
        k = min(len(q), 4096)
        pool[n, :k] = q[:k]
        counts[n] = k
        pos[n] = c.position
        vis[n] = n
        n += 1
    dev_pool = torch.from_numpy(pool.view(np.int32)).to(r.device)
    return dev_pool, vis, counts, pos, n


def graph_frame_ms(r: Renderer, uploads, cam, k: int = 20) -> float:
    """Device ms a frame: ``make_repeated_step(r, k)`` over k cameras about
    ``cam`` (positions + N(0, 0.01)), one graph replay between CUDA
    events (after the capture), over k."""
    rep = make_repeated_step(r, k)
    rng = np.random.default_rng(0)
    cams = np.repeat(cam.position[None], k, 0).astype(np.float32)
    cams += rng.normal(0, 0.01, cams.shape).astype(np.float32)
    vps = np.repeat(cam.view_projection_matrix()[None], k,
                    0).astype(np.float32)
    args = (*uploads, torch.from_numpy(vps).cuda(),
            torch.from_numpy(cams).cuda())
    rep(*args)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    rep(*args)
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / k


def bench_rendering():
    """The reference's ``rendering`` criterion group: the framebuffer's
    clear, a single chunk, a 3x3 world."""
    need_card()
    print(f"== rendering ({torch.cuda.get_device_name(0)}) ==")
    fb = Framebuffer(1280, 720)
    timeit("framebuffer clear (host)", lambda: fb.clear(), n=20)

    def frame(chunks, w, h, name, vcap=32):
        cfg = RenderConfig(width=w, height=h, gather_cap=8192,
                           quads_cap=4096, tile_k_cap=4096,
                           visible_chunks_cap=vcap)
        r = Renderer(cfg, device="cuda")
        pool, vis, counts, pos, _ = upload_pool(r, chunks, vcap)
        cam = Camera(np.array([48.0, 56.0, 80.0], np.float32), w / h)
        cam.look_at(np.array([16.0, 16.0, 16.0], np.float32))
        up = r.prepare_uploads(pool, vis, counts, pos)
        loop_ms = graph_frame_ms(r, up, cam)
        vpj = cam.view_projection_matrix()
        r.render_prepared(up, vpj, cam.position)
        torch.cuda.synchronize()
        k = 20
        t0 = time.perf_counter()
        for _ in range(k):
            out = r.render_prepared(up, vpj, cam.position)
        torch.cuda.synchronize()
        disp_ms = (time.perf_counter() - t0) / k * 1000
        del out
        print(f"{name}: {loop_ms:.3f} ms/frame in one CUDA graph, "
              f"{disp_ms:.3f} ms/frame in separate calls", flush=True)

    frame([Chunk.generate_test_solid((0, 0, 0))], 256, 256,
          "single solid chunk frame 256x256")
    if not QUICK:
        region = [Chunk.generate_terrain((x, 0, z)) for x in range(3)
                  for z in range(3)]
        frame(region, 1280, 720, "3x3 terrain world frame 1280x720")


def bench_device():
    need_card()
    dev = torch.device("cuda")
    print(f"== device ({torch.cuda.get_device_name(0)}) ==")
    # differential projection: K1 on 128k random quads, the origins from
    # per-chunk tables
    rng = np.random.default_rng(0)
    m = 131072
    quads = P.as_quad_words(rng.integers(0, 2**32, m, dtype=np.uint64)
                            .astype(np.uint32)).to(dev)
    slot = torch.from_numpy(rng.integers(0, 256, m)).to(dev)
    cam = Camera(np.array([16.0, 60.0, 90.0], np.float32), 16 / 9)
    cam.look_at(np.array([0.0, 0.0, 0.0]))
    vp = torch.from_numpy(cam.view_projection_matrix().astype(
        np.float32)).to(dev)
    cp = torch.from_numpy(cam.position.astype(np.float32)).to(dev)
    cpos = torch.from_numpy(rng.integers(-6, 6, (256, 3)).astype(
        np.int32)).to(dev)
    cclip = P.chunk_clip_origins(vp, cpos)
    cw = tuple((cpos.float() * 32.0)[:, a] for a in range(3))
    qw = torch.stack(P.quad_world_from_slots(cw, slot))
    n = torch.tensor(m, dtype=torch.int32, device=dev)

    def project():
        return geom_ops.project_cull(quads, qw, n, vp, cp, width=1280,
                                     height=720)["valid_count"]

    dt = median_ms(project, reps=5, batch=20) / 1e3
    print(f"project+cull 131k quads: {dt * 1e3:.3f} ms "
          f"({m / dt / 1e9:.2f} Gquad/s, {m * 4 / dt / 1e9:.2f} Gcorner/s; "
          f"chunk clip origins w[0] {float(cclip[3][0]):.3f})", flush=True)
    if QUICK:
        return

    # device meshing throughput
    chunks = [Chunk.generate_terrain((x, 0, z)) for x in range(4)
              for z in range(4)]
    varied = [c for c in chunks if not c.is_uniform]
    bbp = {tuple(c.position): c.dense() for c in varied}
    planes = torch.from_numpy(MD.neighbor_planes_from_batch(
        bbp, [c.position for c in varied])).to(dev)
    batch = torch.from_numpy(np.stack([c.dense() for c in varied])).to(dev)

    def mesh():
        return MD.mesh_chunks_device(batch, planes, max_steps=64,
                                     qcap=4096)[1].sum()

    dt = median_ms(mesh, reps=3, batch=10) / 1e3
    print(f"device meshing {len(varied)} chunks: {dt * 1e3:.3f} ms "
          f"({len(varied) / dt:,.0f} chunk/s)", flush=True)

    # the span walker's frame (span mode) at 1920x1080, and exact 1280x720
    for mode, w, h in (("span 1920x1080", 1920, 1080),
                       ("exact 1280x720", 1280, 720)):
        cfg = RenderConfig(width=w, height=h,
                           span_mode=mode.startswith("span"),
                           gather_cap=32768, quads_cap=16384,
                           tile_k_cap=4096)
        r = Renderer(cfg, device="cuda")
        pool, vis, counts, pos, placed = upload_pool(r, varied[:16],
                                                     cfg.visible_chunks_cap)
        up = r.prepare_uploads(pool, vis, counts, pos)
        dt = graph_frame_ms(r, up, cam) / 1e3
        print(f"frame ({mode}, {placed} chunks): {dt * 1e3:.3f} ms "
              f"({1 / dt:,.0f} FPS)", flush=True)


def main(argv=None) -> int:
    global QUICK
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", action="store_true",
                    help="include the device cases (the card)")
    ap.add_argument("--quick", action="store_true",
                    help="the first case of each section")
    a = ap.parse_args(argv)
    QUICK = a.quick
    bench_meshing()
    bench_world()
    bench_microbench()
    bench_rendering()
    if a.device:
        bench_device()
    return 0


if __name__ == "__main__":
    sys.exit(main())

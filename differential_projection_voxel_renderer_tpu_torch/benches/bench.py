"""Headline benchmark on the card: full-scene frames a second at 1280x720,
view distance 12, textures and shading on.

The counterpart of the root ``bench.py``, with its flags and passes.  It
runs the complete per-frame pipeline -- the world's streaming check, the
visibility query, the culling funnel (front-to-back sort and horizon
culling) and the device step (stage A, compaction, coefficients, binning,
the tile raster) -- on an Engine at the reference start pose (1280x720,
``WorldConfig(view_distance=vd, frustum_culling=True,
max_chunks_per_frame=16)``, an 8192-slot pool; ``DPVR_TWO_PASS=N`` and
``DPVR_TEMPORAL_HIZ=1`` select the occlusion modes), its world settled,
primed and every loaded chunk meshed (``prime_all``, ``warm_streaming``),
after ``--warmup`` frames:

- static wall: ``--frames`` frames, then ``torch.cuda.synchronize()``;
  best of 3 passes (1 with ``--quick``), the spread logged;
- pipelined wall (frames in flight, one frame of latency): the same
  frames through ``render_frame_pipelined``; its last frame must equal
  the serial one bit for bit, or the bench raises;
- jittered wall: an alternating 1e-6 rad yaw wiggle defeats every
  static-frame cache while the draw list stays, best of 3 passes; and the
  same pipelined, whose last frame must equal a serial frame at the same
  camera, or the bench raises;
- the host loop: the host ms a frame of 30 jittered frames, before the
  card is synchronised;
- the device ms a frame: ``rendering.pipeline.make_repeated_step`` with k
  = 30 jittered cameras, one CUDA graph of 30 steps, the median of 5
  replays between CUDA events, over k;
- conservative FPS, 1000 / max(host ms, device ms);
- the headline: the best of the jittered wall, the jittered pipelined
  wall and the conservative FPS (with ``--quick``, also the static wall);
- the host mesher's ms a 32^3 terrain chunk (best of 5 over 8 chunks);
- PARITY: ``rendering/parity.run_selftests`` and, unless
  ``DPVR_SKIP_FULL_PARITY`` is set, ``run_production_parity`` on the
  static stream (a divergence raises);
- without ``--quick``, first and each in a fresh process, the three
  flythrough modes of ``flythrough_bench`` (serial, ``DPVR_STALE_POOL=1``,
  ``DPVR_RESIDENT=1``); a failed flythrough raises.

    python -m differential_projection_voxel_renderer_tpu_torch.benches.bench [--frames N] [--warmup N] [--vd N] [--quick] [--selftest]

Prints ONE JSON line to stdout, as the original: ``{"metric":
"fps_1280x720_vd<vd>_textured_shaded", "value": FPS, "unit": "fps",
"vs_baseline": FPS / 165, ...}`` with the secondary fields
``static_wall_fps``, ``static_pipelined_fps``, ``jittered_wall_fps``,
``jittered_pipelined_fps``, ``conservative_fps`` and the flythrough's
``fly_*_fps``.  Diagnostics, and the bench's own wall seconds, go to
stderr.  Any failure raises, and the process exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ..meshing.greedy import mesh_chunk
from ..models.chunk import Chunk
from ..ops.raster import SKY_I32
from ..rendering import parity
from ..rendering.pipeline import make_repeated_step
from . import scene as scene_mod
from .common import need_card

BASELINE_FPS = 165.0
JITTER = 1e-6
FLY_MODES = (("", {}), ("stale", {"DPVR_STALE_POOL": "1"}),
             ("resident", {"DPVR_RESIDENT": "1"}))
DEVICE_K = 30

log = scene_mod.log


def sync() -> None:
    torch.cuda.synchronize()


def check_same(a, b, what: str) -> None:
    """Raise unless two frames' colours are equal bit for bit."""
    if not torch.equal(a.color, b.color):
        n = int((a.color != b.color).sum())
        raise AssertionError(f"{what}: {n} pixels differ from the serial "
                             f"frame")


def fly(vd: int, env_extra: dict, timeout: int = 3600) -> tuple:
    """One flythrough_bench run in a fresh process: (pass 1 fps, pass 2
    fps); raises with its error output if it fails or prints no
    FLYTHROUGH line."""
    out = subprocess.run(
        [sys.executable, "-m", f"{__package__}.flythrough_bench", str(vd)],
        capture_output=True, text=True, timeout=timeout,
        env={**os.environ, **env_extra})
    lines = [ln for ln in out.stdout.splitlines()
             if ln.startswith("FLYTHROUGH")]
    if out.returncode or not lines:
        raise RuntimeError(f"flythrough {env_extra} failed (exit "
                           f"{out.returncode}): {out.stderr[-2000:]}")
    _, f1, f2 = lines[0].split()[:3]
    return float(f1), float(f2)


def jittered(eng, base_yaw, i: int) -> None:
    eng.camera.yaw = base_yaw + (JITTER if i % 2 else -JITTER)


def wall_pass(eng, frames: int, pipelined: bool = False, base_yaw=None):
    """``frames`` frames, then the card synchronised: (frames a second,
    the last FrameResult); the yaw wiggles about ``base_yaw`` if given."""
    res = None
    t0 = time.perf_counter()
    for i in range(frames):
        if base_yaw is not None:
            jittered(eng, base_yaw, i)
        if pipelined:
            res = eng.render_frame_pipelined(dt=0.0) or res
        else:
            res = eng.render_frame(dt=0.0)
    if pipelined:
        res = eng.flush_pipeline() or res
    sync()
    return frames / (time.perf_counter() - t0), res


def device_ms(eng, k: int = DEVICE_K, reps: int = 5):
    """(device ms a frame, the stream): ``make_repeated_step`` over k
    jittered cameras (one CUDA graph of k steps) on the engine's last draw
    list expanded, the median of ``reps`` calls between CUDA events, over
    k."""
    rep = make_repeated_step(eng.renderer, k)
    rng = np.random.default_rng(0)
    vps = np.repeat(eng.camera.view_projection_matrix()[None], k, 0)
    cams = np.repeat(eng.camera.position[None], k, 0).astype(np.float32)
    cams += rng.normal(0, 0.01, cams.shape).astype(np.float32)
    uploads = eng.renderer.prepare_uploads(
        eng.pool.quads, eng._last_visible_slots, eng._last_counts_sel,
        eng._last_positions_sel, dir_mask=eng._last_dir_mask)
    args = (*uploads, torch.from_numpy(vps.astype(np.float32)).cuda(),
            torch.from_numpy(cams).cuda())
    rep(*args)  # capture
    sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        rep(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / k)
    return statistics.median(times), uploads


def meshing_ms() -> float:
    """The host mesher's ms a 32^3 terrain chunk, best of 5 over 8."""
    terr = [Chunk.generate_terrain((x, 0, 0)) for x in range(8)]
    for c in terr:
        mesh_chunk(c)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for c in terr:
            mesh_chunk(c)
        best = min(best, (time.perf_counter() - t0) / len(terr))
    return best * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--warmup", type=int, default=16)
    ap.add_argument("--vd", type=int, default=12)
    ap.add_argument("--quick", action="store_true",
                    help="small scene for fast validation")
    ap.add_argument("--selftest", action="store_true",
                    help="run only the kernel parity self-tests")
    args = ap.parse_args(argv)
    need_card()
    t_bench = time.perf_counter()

    if args.selftest:
        verdict = parity.run_selftests(device="cuda")
        log(f"PARITY: kernels vs plain twins on "
            f"{torch.cuda.get_device_name(0)}: {verdict}")
        print(json.dumps({"metric": "kernel_parity", "value": 1,
                          "unit": "pass", "vs_baseline": 1.0}))
        return 0

    # the flythrough modes first, each in a fresh process, before this
    # process takes the card
    fly_vals, fly_lines = {}, []
    if not args.quick:
        for mode, env in FLY_MODES:
            f1, f2 = fly(args.vd, env)
            tag = f"fly_{mode}_" if mode else "fly_"
            fly_vals.update({f"{tag}primed_fps": f1,
                             f"{tag}streaming_fps": f2})
            fly_lines.append(f"flythrough{' ' + mode if mode else ''} "
                             f"(streaming + remesh + moving camera, fresh "
                             f"process): {f1} FPS primed / {f2} FPS "
                             f"streaming")

    if args.quick:
        args.vd = min(args.vd, 4)
        args.frames = min(args.frames, 30)
    log(f"device: {torch.cuda.get_device_name(0)}, torch "
        f"{torch.__version__}")

    t0 = time.perf_counter()
    eng = scene_mod.new_engine(
        args.vd, two_pass_near_quads=int(os.environ.get("DPVR_TWO_PASS",
                                                        "0")),
        temporal_hiz=bool(int(os.environ.get("DPVR_TEMPORAL_HIZ", "0"))))
    log(f"world: {eng.world.chunk_count()} chunks "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    eng.prime()
    log(f"meshing: {len(eng.pool.by_pos)} cache entries "
        f"({time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    eng.prime_all()
    eng.warm_streaming()
    sync()
    log(f"prime_all: {len(eng.pool.by_pos)} meshes "
        f"({time.perf_counter() - t0:.1f}s)")

    res = None
    for _ in range(args.warmup):
        res = eng.render_frame(dt=0.0)
    sync()
    log(f"warm frame stats: {res.stats.cpu().numpy()} "
        f"rendered={res.rendered_meshes}/{res.visible_chunks}")

    pass_fps = []
    for p in range(1 if args.quick else 3):
        fps, res = wall_pass(eng, args.frames)
        pass_fps.append(fps)
        log(f"pass {p}: {args.frames} frames in {args.frames / fps:.3f}s "
            f"-> {fps:.1f} FPS ({1000 / fps:.3f} ms/frame)")
    wall_fps = max(pass_fps)
    log(f"wall FPS: best of {len(pass_fps)} passes = {wall_fps:.1f} "
        f"(spread {min(pass_fps):.1f}-{max(pass_fps):.1f})")

    pipe_fps = jit_fps = jit_pipe_fps = 0.0
    if not args.quick:
        # frames in flight at the static pose: its steps run once outside
        # the clock; its frames must equal the serial one
        eng.render_frame_pipelined(dt=0.0)
        eng.render_frame_pipelined(dt=0.0)
        eng.flush_pipeline()
        pipe_fps, res_p = wall_pass(eng, args.frames, pipelined=True)
        log(f"pipelined wall pass: {pipe_fps:.1f} FPS "
            f"({1000 / pipe_fps:.3f} ms/frame; frames-in-flight, one "
            f"frame of latency)")
        check_same(res_p, res, "the pipelined static frame")

        base_yaw = eng.camera.yaw
        jit_passes = [wall_pass(eng, args.frames, base_yaw=base_yaw)[0]
                      for _ in range(3)]
        jit_fps = max(jit_passes)
        eng.camera.yaw = base_yaw
        log(f"jittered-camera wall pass: best of 3 = {jit_fps:.1f} FPS "
            f"(spread {min(jit_passes):.1f}-{max(jit_passes):.1f}; "
            f"sub-pixel yaw wiggle, every cache of a static frame "
            f"defeated, draw list unchanged)")

        eng.render_frame_pipelined(dt=0.0)
        eng.flush_pipeline()
        jit_pipe_fps, res_jp = wall_pass(eng, args.frames, pipelined=True,
                                         base_yaw=base_yaw)
        log(f"jittered pipelined wall pass: {jit_pipe_fps:.1f} FPS "
            f"({1000 / jit_pipe_fps:.3f} ms/frame; frames-in-flight, one "
            f"frame of latency)")
        res_serial = eng.render_frame(dt=0.0)
        check_same(res_jp, res_serial,
                   "the jittered pipelined frame at the same camera")
        eng.camera.yaw = base_yaw

    # the host's share of the loop (funnel and calls), jittered
    base_yaw = eng.camera.yaw
    n_host = min(args.frames, 30)
    sync()
    t0 = time.perf_counter()
    for i in range(n_host):
        jittered(eng, base_yaw, i)
        res = eng.render_frame(dt=0.0)
    host_ms = (time.perf_counter() - t0) / n_host * 1000
    sync()
    eng.camera.yaw = base_yaw
    log(f"host-side per-frame (culling + calls, jittered): "
        f"{host_ms:.3f} ms")

    dev_ms, uploads = device_ms(eng)
    log(f"device per-frame (one CUDA graph x{DEVICE_K}): {dev_ms:.3f} ms")
    conservative_fps = 1000.0 / max(host_ms, dev_ms)
    log(f"conservative FPS (max of host, device): {conservative_fps:.1f}")
    cands = {"jittered wall": jit_fps, "conservative": conservative_fps,
             "jittered pipelined wall (1-frame latency)": jit_pipe_fps}
    if args.quick:
        cands["wall"] = wall_fps  # quick mode skips the jittered passes
    which = max(cands, key=cands.get)
    fps = cands[which]
    log(f"headline = {which} ({fps:.1f} FPS); static wall {wall_fps:.1f} "
        f"/ static pipelined {pipe_fps:.1f} recorded as secondary")
    log(f"final frame non-sky pixels: {int((res.color != SKY_I32).sum())}")

    log(f"meshing: {meshing_ms():.3f} ms per 32^3 terrain chunk (host, "
        f"native, best of 5)")

    verdict = parity.run_selftests(device="cuda")
    log(f"PARITY: kernels vs plain twins on "
        f"{torch.cuda.get_device_name(0)}: {verdict}")
    if not os.environ.get("DPVR_SKIP_FULL_PARITY"):
        v2 = parity.run_production_parity(
            eng.renderer, uploads, eng.camera.view_projection_matrix(),
            eng.camera.position)
        log(f"PARITY (production frame): {v2}")
    for line in fly_lines:
        log(line)
    log(f"bench wall: {time.perf_counter() - t_bench:.1f} s")

    print(json.dumps({
        "metric": f"fps_1280x720_vd{args.vd}_textured_shaded",
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / BASELINE_FPS, 3),
        "static_wall_fps": round(wall_fps, 2),
        "static_pipelined_fps": round(pipe_fps, 2),
        "jittered_wall_fps": round(jit_fps, 2),
        "jittered_pipelined_fps": round(jit_pipe_fps, 2),
        "conservative_fps": round(conservative_fps, 2),
        **{k: round(v, 1) for k, v in fly_vals.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

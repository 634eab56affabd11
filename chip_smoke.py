#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``csrc/`` (nvcc, sm_90a), drives the
serial frame path of ``Engine.render_frame`` (also in the two-pass and
temporal Hi-Z modes, in span mode and with device meshing), the legacy
vertex renderer, the frames-in-flight path of
``Engine.render_frame_pipelined``, the packed raster path, the row
bands and camera batch of ``parallel/sharded_render.py``, the
application surface (warm-ups, flythrough, stale pool, shading toggle,
production parity, graft entry points, demo) and the resident superset
stream (``Engine(resident_stream=True)``) at the
headline scene (1280x720, view distance 12, textures and shading on, from
the reference start pose) and the cost-probe path at the probes' 736x1280
frame, holds each kernel against its plain PyTorch version on the card,
and times kernels and frames.  Phases:

1. environment (torch, CUDA, nvcc, the card's name and power limit);
2. kernel build, the count of floating-point multiply-adds in each
   source's PTX (the rounding contract wants none), and ptxas's registers,
   spills and shared memory of each kernel with the resident blocks an SM
   holds of K2/K3 and K4 (no spills and at least 4 blocks, or it fails),
   and of K1's three instances (one, two and four quads a thread; no
   spills, or it fails);
3. the serial path: world streamed until settled, prime(), 3 static frames
   (render_fused, then render_prepared), 50 timed static frames, then 10
   moving frames that stream chunks (render_fused_insert where the remesh
   batch fits its payload, else render_fused).  The kernels' launch
   counters are zeroed before it and read after it; K1 and K2 must grow on
   every frame, and the stats must show no overflow.  The static and
   moving frames are kept for phase 8;
4. K1 (stage A) vs its twin, bit-exact on all five outputs and both
   counts (subpix_total, valid_count): a fuzzed 131072-quad stream (n
   120000), the real vd12 stream at its bucket, the same with
   ``skip_quads`` (a device scalar) and with ``subpixel_culling=False``,
   and a fuzzed stream of 131069 quads, not a multiple of 4 (the
   kernel's four-quad groups: the quads go one by one);
5. K2 (tile raster) vs its twin on the port's own records at 128x128,
   640x128 and 1280x720: full-frame equality, or the boundary-verified
   gate with its mismatch count; and the 128x128 frame on the card vs the
   same step on the CPU (the twins);
6. kernel and twin times at the vd12 shapes, median of 20 runs each;
   K1 at 131072 quads and at the vd12 bucket a call, in runs of 20 and
   from a CUDA graph, with its bound at each;
7. the static frame's device time under torch.profiler: the card's busy
   time per frame, its idle share and the largest device activities;
8. frames in flight: a second Engine, settled and primed like the first,
   drives render_frame_pipelined over phase 3's camera sequence (3 static,
   20 timed static, the 10 moving frames), then flush_pipeline.  The
   counters are zeroed before it and read after it; K3 must launch once on
   every steady step (a frame of the carried frame's gather cap), only a
   change of cap may drain, and every emitted frame must equal phase 3's
   serial frame for the same pose bit for bit (colour, depth, stats[:2]),
   once and in order.  The pipelined static frame time is printed beside
   phase 3's;
9. K3 (the raster with the next frame's stage A) vs K2 and K1 on the vd12
   records, with the fuzzed 131072-quad stream and then the real vd12
   stream as the next stream: its frame must equal K2's and its geometry
   K1's, bit for bit; then K3's time against a K2 plus a K1 launch (median
   of 20) and against its plain version (median of 5);
10. the packed raster (RenderConfig.packed_raster): a third Engine,
   settled and primed like the first, drives phase 3's camera sequence (3
   static, 20 timed static, the 10 moving frames).  The counters are
   zeroed before it and read after it; every frame must launch K1 and K4
   once and K2/K3 never, show no overflow, and equal phase 3's serial frame
   of its pose bit for bit (colour, depth, stats[:2]).  Then 10 packed
   frames under torch.profiler; K4 (the packed tile raster) vs its plain
   version, bit-exact, on the port's packed records at 128x128, 640x128
   and 1280x720 (where its frame must also equal K2's), and the 128x128
   packed frame on the card vs the same step on the CPU; K4's time (a call
   and in runs of 20) beside K2's on the default records of the same pose,
   its plain version's, on the wide bins alone, on the buckets alone and
   on the tile with the longest slice walk alone, and its bound (its walk
   found as the per-bin occlusion break finds it in the plain version's
   order, the fewest items any order of K4's slices walks);
11. the cost-probe path (the port's ``benches``: the TPU cost probes
   ``benches/micro_fixed.py``, ``micro_fixed2.py`` and ``micro_fixed3.py``
   as probes of the port's launch path): the counters are zeroed, every
   variant (micro_fixed's levels 0-2, micro_fixed2's 63 labels and its
   SOLO10 sweep 1x1 .. 4x5, micro_fixed3's levels 0-3 and h0-h4) is
   driven once through its module's ``run_variant`` and the counters are
   read; each must launch its kernel (M1, M2, or K2 on the empty stream)
   as often as it calls it.  Every output must equal the plain versions'
   bit for bit where the kernel writes (levels 1-2 also on random tile
   counts, which stage records), and K2's empty frame must be the constant
   frame.  Each variant is timed (a call, runs of 20, 30 queued, from a
   CUDA graph, host us a call) beside its plain version, its library call
   (``Tensor.fill_`` on each output for M1 and K2, ``torch.add`` into each
   output for M2; in runs of 20, from a CUDA graph and by host us) and its
   bound, and beside its launches a call times the graph launch floor
   (``torch.cuda._sleep(0)``, a launch that does no work, from a CUDA
   graph) plus its bound, with and without the torch ops its run makes
   around its calls; the variants within 1.5x of it are counted
   (``benches/probe_call.py`` drives, checks and times them); then the
   host us a launch against the operand count, K1's, M1's and M2's C
   entry points called alone, and K2's empty floor beside its vd12 time
   of phase 6;
12. exact occlusion: a two-pass engine (RenderConfig(two_pass_near_quads=
   8192)) and a temporal one (RenderConfig(temporal_hiz=True)), settled
   and primed like the first, drive phase 3's camera sequence (3 static
   frames, the 10 moving frames) with the counters zeroed before and read
   per frame (two-pass: K1 once, K2 twice; temporal: K1 and K2 once).
   Every frame must equal phase 3's of its pose bit for bit (colour, depth,
   stats[0], and stats[1] + stats[5], the rasterized and the Hi-Z-culled
   counts); the temporal engine's first two static frames cull nothing
   (the plain path, then the seed), its later static frames cull, its
   moving frames never.  Then the three engines' static frames are timed
   at the start pose in alternating blocks of 20 (serial, two-pass,
   temporal, temporal, two-pass, serial), each frame checked on the card;
   K2 with an init frame (the far pass on the near pass's frame: the wall
   scene at 128x128 and the vd12 static stream) against its plain version
   and against the single pass; K2 with and without the init frame on the
   same vd12 records, a call and in runs of 20; the Hi-Z cull at vd12
   recomputed on stage A with the port's 4-ulp margin and with the
   reference's strict test, and the quads on which they differ;
13. row bands and the camera batch on the phase-3 engine's pool:
   ``parallel/sharded_render.make_sharded_render`` with dp = 2 cameras
   (phase 3's static and last moving pose and draw lists) and tp = 2
   (360-row bands in 368-row buffers) and tp = 3 (240 rows): K1 and K2
   launch tp times a camera, and the stacked bands must equal phase 3's
   frames bit for bit; ``make_sharded_render_dp`` over the two cameras
   too.  K2 with ``y0_px`` against its plain version on the last band of
   each split (K2 must leave a padded buffer's padded rows as they
   started; the pixels each writes there are printed), and each band's K2
   time beside the full frame's;
14. the application surface, each part with the counters zeroed before
   and read after it: a fresh engine of phase 3's configuration primed
   with ``prime_all``; ``warm_buckets()``, a frame at the start pose (equal
   to phase 3's static frame bit for bit) and ``warm_streaming()`` (the
   pool unchanged); ``app/flythrough.run_flythrough`` over
   ``default_path(24)`` (frames a second by CUDA events and the host
   clock; K1 and K2 once a frame); the same keys on a second engine in
   the one-frame-stale pool mode (warmed with
   ``warm_buckets(pipelined=True)``, which launches K3), the frames that
   differ from the serial ones and the chunks meshed late counted, then
   with the camera held at the last key its second frame equal to the
   serial engine's bit for bit and the pools equal chunk by chunk; the
   same for a serial and a stale engine primed with ``prime()`` only,
   whose flight streams visible chunks (some frames must differ);
   ``toggle_shading()`` twice on the
   phase-3 engine (coverage and depth kept, colours changed, the frame
   after toggling back equal bit for bit);
   ``rendering/parity.run_production_parity`` on phase 3's vd12 static
   stream (its verdict, the PARITY line); ``graft_entry.entry()`` and
   ``dryrun_multichip(4)`` and ``(8)``; the demo's ``main`` into a
   temporary PPM at 1280x720, view distance 6 (its size checked).  The
   seconds of each part are printed;
15. the resident superset stream (RenderConfig's defaults widened by the
   mode: gather cap 262144, item cap 131072, 1024 draw-list slots), each
   part with the counters zeroed before and read after it: an engine
   primed with ``prime_all``, ``warm_resident()`` (the pool unchanged),
   the start pose's frame (equal to phase 3's static frame bit for bit)
   and ``default_path(24)`` (every frame equal to phase 14's primed serial
   flight bit for bit in colour and depth, no fallback, at least one
   rebuild, K1 and K2 once a frame); an engine primed with ``prime()``
   only over the same keys (its frames against phase 14's stale engine's),
   then held at the last key until its stash drains (appends and fused
   inserts must have run), ``invalidate_resident()`` and a frame equal to
   phase 14's serial engine's bit for bit, whose pool's chunks must all be
   in the resident pool; K1 and K2 against their plain versions bit for
   bit on a resident stream at the 262144-quad shape (compaction on, item
   cap 131072), with their device time from a CUDA graph and their bound;
   the resident-append, fused-insert and pipelined self-tests on the card
   ("exact"); resident against serial flights, primed and streaming, in
   alternating turns on fresh engines (frames a second by CUDA events and
   the host clock); 10 profiled resident moving frames;
16. the last three paths, each part with the counters zeroed before and
   read after it: (a) span mode, an Engine(RenderConfig(span_mode=True))
   settled and primed over phase 3's camera sequence with the plain
   versions of K1 and K2 made to raise (K1's span instance and K2 once a
   frame, K3 and K4 never), K1-span and K2 on the span records against
   their plain versions bit for bit, the two-pass, temporal and tp = 2
   band span frames equal to the serial span frame, the fuzz scene's span
   frame against oracle.render_span (0.1% of pixels, depth 1e-4), and
   K1-span's time (a call, in runs, from a CUDA graph) and bound; (b)
   device meshing, a host-meshed and a device-meshed prime_all engine
   (the seconds of each meshing the settle batch), their pools equal
   chunk by chunk and every frame at phase 3's poses equal between them
   and to phase 3's; (c) the legacy vertex renderer on a terrain chunk's
   mesh at 1280x720 on the card (seconds, non-sky pixels) and at 320x180
   equal to the CPU's frame bit for bit;
17. the measuring side (the port's ``benches/``): ``rendering/pipeline.
   make_repeated_step`` on phase 3's static stream over 4 cameras, its
   first call one eager step and 4 captured in a CUDA graph (K1 and K2
   launched 5 times by their wrappers), its last frame equal to an eager
   ``render_step`` on the 4th camera bit for bit, a replay launching
   through no wrapper, and the step's device ms a frame from a 30-step
   graph beside phase 7's device busy; every bench module (bench --quick,
   profile_stages with every stage, micro_project, micro_hiz, micro_sort,
   pipeline_experiment, fly_profile, flythrough_diag, run_benches
   --device --quick, kernel_cost_sim) at its smallest setting, each of
   whose output lines must parse, and one flythrough_bench pass in a fresh
   process; kernel_cost_sim's counts at the start pose equal to phase 9's.
   The phase's seconds are printed;
18. the binnings on the flights where they dropped visible quads, each
   part with the counters zeroed before and read after it: a packed
   engine primed with ``prime_all`` over ``default_path(24)`` (stats[3] 0
   on every key, every frame equal to phase 14's primed serial flight bit
   for bit, K1 and K4 once a frame), and a serial and a resident engine
   primed alike over ``default_path(96)``, the same orbit at four times
   the keys (stats[3] 0 on every key of both, every resident frame equal
   to the serial frame of its key bit for bit).

The script imports the port package and nothing else of the repo; before
it prints its result it checks that neither jax nor any module of the JAX
package was loaded.  Every number printed comes from this run; each
kernel's bound is computed from this run's inputs (``bound_ms``: the larger
of its bytes over the card's memory rate and its operations over the
card's float32 rate).  Its last three lines are the JSON object with one
entry per kernel (K1-K4, and M1 at ``a_base`` and M2 at ``make9``'s 4x5
form with every probe site each replaces; K2's entry also gives its empty
floor, its launches on the paths of phases 12-13, its time with an init
frame and each band's, its wrapper's host us and the production parity
verdict; K1-K3 give their launches on each part of phase 14, K1-K4 on
each part of phase 15, K1, K2 and K4 on each part of phase 18, M1 and
M2 the graph launch floor and their variants within it, K1 and K2 their
time, plain time and bound at the
resident shapes, K3 and K4 their device time from a CUDA graph, K1 its
span instance's launches, error, times, bound, registers and spills and
K2 its launches on phase 16's span frames), the
card's name and power limit as nvidia-smi gives them, and ``{"ok": true,
"device": {...}}``.  Exits non-zero, printing no
result, when there is no CUDA device or the package is not beside this
script.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = "differential_projection_voxel_renderer_tpu_torch"
REF = "differential_projection_voxel_renderer_tpu"
WIDTH, HEIGHT, VIEW_DISTANCE = 1280, 720, 12
START_POS, START_TARGET = (0.0, 10.0, 20.0), (0.0, 0.0, -60.0)
N_TIMED, N_TIMED_PIPELINED, N_MOVING = 50, 20, 10
# phase 14's flythrough: default_path's keys; its pools, primed with
# prime_all: the world settled at the start pose and at the last key holds
# about as many chunks as the JAX benches' 8192 slots (phase 14 prints it)
FLY_KEYS = 24
APP_POOL_SLOTS = 16384
# phase 18's long flight: default_path's orbit at four times the keys, so
# that several frames fall in each chunk cell
LONG_KEYS = 96
# phase 15: the frames a stash may take to drain with the camera held, and
# the turns of each mode in the frames-a-second comparison
SETTLE_FRAMES = 2000
FLY_TURNS = 3
# exact occlusion: the two-pass mode's near pass (MacrotileRenderConfig's
# default), and the wall scene's (tests/test_macrotile.py)
NEAR_QUADS, WALL_NEAR = 8192, 16

# NVIDIA H100 SXM data sheet: HBM rate and dense float32 rate outside the
# tensor cores, at the full 700 W power limit.  The float32 rate counts a
# fused multiply-add as two operations; the kernels are built with
# -fmad=false and issue none, so for the operations counted below their
# own issue limit is half that rate (the bounds keep the data sheet's)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
N_SMS = 132
# float32 operations stage A needs per quad, counted from the sources (the
# basis, four projected corners, the NDC divides, min/max, the frustum,
# backface and sub-pixel tests and the bbox); the tile raster's per pixel
# and per item column are benches/kernel_cost_sim.py's K2_OPS_PER_PIXEL
# and K2_OPS_PER_ITEM_COLUMN
K1_OPS_PER_QUAD = 200
# the turns of phase 11's host-time comparisons
PROBE_TURNS = 7


def log(msg: str) -> None:
    print(msg, flush=True)


def run(cmd) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
        return (out.stdout or out.stderr).strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"


def smi() -> str:
    return run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]


def median_ms(fn, reps: int = 20, batch: int = 1) -> float:
    """Median over ``reps`` runs of the CUDA-event time of ``batch``
    back-to-back calls of ``fn``, per call, after one warm-up call (the
    cost probes' ``common.median_ms``)."""
    from differential_projection_voxel_renderer_tpu_torch.benches import (
        common,
    )

    return common.median_ms(fn, reps, batch)


def nonsky(color) -> int:
    from differential_projection_voxel_renderer_tpu_torch.ops.raster import (
        SKY_I32,
    )

    return int((color != SKY_I32).sum())


def counters():
    """Launch counts (K1, K2, K3, K4)."""
    from differential_projection_voxel_renderer_tpu_torch.ops import (
        geometry,
        raster,
        raster_packed,
    )

    return (geometry.launches, raster.launches, raster.launches_geom,
            raster_packed.launches)


def reset_counters() -> None:
    from differential_projection_voxel_renderer_tpu_torch.ops import (
        geometry,
        micro,
        raster,
        raster_packed,
    )

    geometry.launches = 0
    geometry.launches_span = 0
    raster.launches = 0
    raster.launches_geom = 0
    raster_packed.launches = 0
    micro.launches_fill = 0
    micro.launches_copy = 0


# ------------------------------------------------------------- main path


def new_engine(torch, config=None, prime_all=False, pool_slots=4096,
               resident=False, device_meshing=False):
    """An Engine on the card at the headline scene (``config``, by default
    RenderConfig(WIDTH, HEIGHT); in the resident superset stream mode with
    ``resident``, meshing on the card with ``device_meshing``), its world
    settled and primed at the start pose (every loaded chunk meshed with
    ``prime_all``): (engine, world seconds, prime seconds, the card
    synchronised)."""
    import numpy as np

    from differential_projection_voxel_renderer_tpu_torch.app.engine import (
        Engine,
        RenderConfig,
        WorldConfig,
    )

    t0 = time.perf_counter()
    eng = Engine(config or RenderConfig(WIDTH, HEIGHT),
                 WorldConfig(view_distance=VIEW_DISTANCE),
                 pool_slots=pool_slots, resident_stream=resident,
                 device_meshing=device_meshing)
    eng.camera.position = np.array(START_POS, np.float32)
    eng.camera.look_at(np.array(START_TARGET, np.float32))
    while eng.world.update(eng.camera.position):
        pass
    t1 = time.perf_counter()
    if prime_all:
        eng.prime_all()
    else:
        eng.prime()
    torch.cuda.synchronize()
    return eng, t1 - t0, time.perf_counter() - t1


def moving_poses():
    """The moving frames' camera poses: creep forward and yaw 0.75 degrees
    a frame, so that loaded but not yet meshed chunks turn visible a few at
    a time and stream in as remesh batches small enough for the fused
    insert."""
    import numpy as np

    pos = np.array(START_POS, np.float32)
    look = np.array(START_TARGET, np.float32) - pos
    for i in range(N_MOVING):
        pos[2] -= 2.0
        a = np.radians(0.75 * (i + 1))
        rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]], np.float32)
        yield pos.copy(), pos + rot @ look


def keep(res):
    """A frame's (colour, depth, stats) as device copies."""
    return res.color.clone(), res.depth.clone(), res.stats.clone()


def count_entry_points(renderer) -> dict:
    """Wrap the renderer's three serial entry points so that each call that
    renders counts in the returned dict."""
    entry = {}
    for name in ("render_fused", "render_prepared", "render_fused_insert"):
        def wrap(fn, name=name):
            def call(*a, **kw):
                out = fn(*a, **kw)
                if out is not None:
                    entry[name] = entry.get(name, 0) + 1
                return out
            return call
        setattr(renderer, name, wrap(getattr(renderer, name)))
    return entry


def main_path(torch):
    eng, t_world, t_prime = new_engine(torch)
    log(f"[3] world: {eng.world.chunk_count()} chunks in {t_world:.1f} s; "
        f"prime: {len(eng.pool.by_pos)} meshes in {t_prime:.1f} s")

    entry = count_entry_points(eng.renderer)

    def frame(check: bool):
        before = counters()
        res = eng.render_frame(dt=0.0)
        after = counters()
        if not (after[0] > before[0] and after[1] > before[1]):
            raise AssertionError(f"a kernel did not launch: {before} {after}")
        if check:
            st = res.stats.cpu().numpy()
            n = nonsky(res.color)
            if st[2] != 0 or st[3] != 0:
                raise AssertionError(f"overflow in stats {st}")
            if not WIDTH * HEIGHT // 4 < n < WIDTH * HEIGHT:
                raise AssertionError(f"implausible non-sky count {n}")
            return res, st, n
        return res, None, None

    torch.cuda.synchronize()
    reset_counters()
    static_frames = []
    for i in range(3):
        res, st, n = frame(True)
        static_frames.append(keep(res))
        log(f"[3] static frame {i}: stats={st.tolist()} non-sky={n} "
            f"entry={dict(entry)}")
    for f in static_frames[1:]:
        if not all(torch.equal(a, b) for a, b in zip(f, static_frames[0])):
            raise AssertionError("the static frames differ")
    static_list = draw_list(eng)
    cams = [(eng.camera.view_projection_matrix(), eng.camera.position.copy())]
    # the static draw list's stream and camera, for the kernel checks
    static = (eng._upload_cache[1], eng.camera.view_projection_matrix(),
              eng.camera.position.copy())
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    ev0.record()
    for _ in range(N_TIMED):
        frame(False)
    ev1.record()
    ev1.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / N_TIMED
    dev_ms = ev0.elapsed_time(ev1) / N_TIMED
    moving = []
    for i, (pos, target) in enumerate(moving_poses()):
        eng.camera.position = pos
        eng.camera.look_at(target)
        res, st, n = frame(True)
        moving.append(keep(res))
        log(f"[3] moving frame {i}: stats={st.tolist()} non-sky={n} "
            f"meshes={len(eng.pool.by_pos)} entry={dict(entry)}")
    moving_list = draw_list(eng)
    cams.append((eng.camera.view_projection_matrix(),
                 eng.camera.position.copy()))
    torch.cuda.synchronize()
    launches = counters()
    frames = 3 + N_TIMED + N_MOVING
    if launches != (frames, frames, 0, 0):
        raise AssertionError(f"launches {launches} for {frames} frames")
    if not entry.get("render_fused_insert"):
        raise AssertionError(f"no frame took render_fused_insert: {entry}")
    log(f"[3] main path: {frames} frames, launches K1={launches[0]} "
        f"K2={launches[1]}, entry points {entry}")
    log(f"[3] static frame: {dev_ms:.3f} ms/frame between CUDA events, "
        f"{host_ms:.3f} ms/frame host clock (mean of {N_TIMED})")
    serial = dict(static=static_frames[0], moving=moving,
                  lists=(static_list, moving_list), cams=cams)
    return (eng, static, launches, dict(static_ms=dev_ms, host_ms=host_ms),
            serial)


def draw_list(eng):
    """The chunk positions of the frame just rendered, front to back (its
    draw list, as positions: pool slots may be reused later)."""
    n = eng._last_n_visible
    return eng.pool.positions[eng._last_visible_slots[:n]].copy()


def same_frame(torch, res, ref):
    """A device bool: ``res`` shows ``ref``'s colour, depth bits and
    stats[:2] (no host sync)."""
    return ((res.color == ref[0]).all()
            & (res.depth.view(torch.int32) == ref[1].view(torch.int32)).all()
            & (res.stats[:2] == ref[2][:2]).all())


def same_culled_frame(torch, res, ref):
    """``same_frame`` for a frame with the Hi-Z cull: ``ref``'s colour and
    depth bits, its gathered count, and its rasterized count split into
    the rasterized and the culled (stats[1] + stats[5])."""
    return ((res.color == ref[0]).all()
            & (res.depth.view(torch.int32) == ref[1].view(torch.int32)).all()
            & (res.stats[0] == ref[2][0])
            & (res.stats[1] + res.stats[5] == ref[2][1]))


def pipelined_path(torch, serial):
    """Phase 8: frames in flight on a second engine over phase 3's camera
    sequence, every emitted frame held against the serial frame of its
    pose, once and in order.  At the static pose the pipelined frames are
    timed against serial frames of the same engine in alternating blocks
    (serial, pipelined, pipelined, serial); each block checks its frames
    on the card, and a pipelined block is seeded and flushed outside the
    timer, so it times steady steps only.
    Then 10 frames of each mode run under torch.profiler.  Returns
    (launches, {"serial"|"pipelined": [(events ms, host ms) per block]},
    {"serial"|"pipelined": profile_frames' result})."""
    eng, t_world, t_prime = new_engine(torch)
    log(f"[8] second engine: {eng.world.chunk_count()} chunks in "
        f"{t_world:.1f} s; prime: {len(eng.pool.by_pos)} meshes in "
        f"{t_prime:.1f} s")
    # (call, (K1, K2, K3, K4) launches, carried gather cap before, after)
    steps = []

    def carried():
        carry = eng.renderer._pipe_carry
        return None if carry is None else carry[0]

    def call(kind):
        before, cap0 = counters(), carried()
        fn = {"serial": eng.render_frame,
              "pipelined": eng.render_frame_pipelined}.get(kind)
        res = eng.flush_pipeline() if fn is None else fn(dt=0.0)
        steps.append((kind, tuple(a - b for a, b in zip(counters(), before)),
                      cap0, carried()))
        return res

    def check(res, ref, what):
        if res is None or not bool(same_frame(torch, res, ref)):
            raise AssertionError(f"{what} differs from the serial frame of "
                                 f"its pose")

    static = serial["static"]
    torch.cuda.synchronize()
    reset_counters()
    emitted = 0
    for i in range(3):
        res = call("pipelined")
        if res is not None:
            check(res, static, f"pipelined static frame {emitted}")
            emitted += 1
    check(call("flush"), static, "the flushed static frame")
    emitted += 1
    times = {"serial": [], "pipelined": []}
    for kind in ("serial", "pipelined", "pipelined", "serial"):
        ok = torch.ones((), dtype=torch.bool, device=eng.device)
        n_out = 0
        if kind == "pipelined":
            if call(kind) is not None:  # seed the empty pipeline
                raise AssertionError("a seeding call emitted a frame")
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        ev0.record()
        for _ in range(N_TIMED_PIPELINED):
            res = call(kind)
            if res is not None:
                ok = ok & same_frame(torch, res, static)
                n_out += 1
        ev1.record()
        ev1.synchronize()
        times[kind].append((ev0.elapsed_time(ev1) / N_TIMED_PIPELINED,
                            (time.perf_counter() - h0) * 1e3
                            / N_TIMED_PIPELINED))
        if kind == "pipelined":
            ok = ok & same_frame(torch, call("flush"), static)
            n_out += 1
        # a pipelined block enters one frame more than it times: the seed
        if not bool(ok) or n_out != N_TIMED_PIPELINED + (kind == "pipelined"):
            raise AssertionError(f"a {kind} static frame differs from the "
                                 f"serial frame ({n_out} emitted)")
        if kind == "pipelined":
            emitted += n_out
    profiles = {}
    for mode in ("serial", "pipelined"):
        outs = []
        profiles[mode] = profile_frames(
            torch, lambda mode=mode: outs.append(call(mode)))
        if mode == "pipelined":
            outs.append(call("flush"))
        outs = [r for r in outs if r is not None]
        if len(outs) != 11 or not all(bool(same_frame(torch, r, static))
                                      for r in outs):
            raise AssertionError(f"a profiled {mode} frame differs from the "
                                 f"serial frame")
        emitted += len(outs) if mode == "pipelined" else 0
    moving = serial["moving"]
    j = 0
    for pos, target in moving_poses():
        eng.camera.position = pos
        eng.camera.look_at(target)
        res = call("pipelined")
        if res is not None:
            check(res, moving[j], f"pipelined moving frame {j}")
            j += 1
    check(call("flush"), moving[j], f"pipelined moving frame {j}")
    j += 1
    if j != len(moving) or call("flush") is not None:
        raise AssertionError(f"{j} moving frames emitted for {len(moving)}")
    emitted += j
    torch.cuda.synchronize()
    launches = counters()

    # a serial frame launches K1 and K2; the first pipelined call on an
    # empty pipeline seeds it (K1); a steady step, whose frame has the
    # carried frame's gather cap, launches K3 once; a frame of another cap
    # drains the carried frame serially and seeds again (K1 twice, K2); a
    # flush of a carried frame is serial (K1, K2), of an empty one nothing
    drains = steady = 0
    for i, (kind, got, cap0, cap1) in enumerate(steps):
        if kind == "serial":
            want = (1, 1, 0, 0)
        elif kind == "flush":
            want = (0, 0, 0, 0) if cap0 is None else (1, 1, 0, 0)
        elif cap0 is None:
            want = (1, 0, 0, 0)
        elif cap0 == cap1:
            want, steady = (0, 0, 1, 0), steady + 1
        else:
            want, drains = (2, 1, 0, 0), drains + 1
        if got != want:
            raise AssertionError(f"call {i} ({kind}, cap {cap0} -> {cap1}) "
                                 f"launched K1-K4 {got}, expected {want}")
    if (launches[2] != steady
            or launches != tuple(map(sum, zip(*(g for _, g, _, _ in steps))))):
        raise AssertionError(f"launches {launches} over the calls, "
                             f"{steady} steady steps")
    log(f"[8] frames in flight: {emitted} pipelined frames emitted in order, "
        f"each equal to the serial frame of its pose bit for bit (colour, "
        f"depth, stats[:2]); launches K1={launches[0]} K2={launches[1]} "
        f"K3={launches[2]} over {len(steps)} calls; K3 launched once on "
        f"each of the {steady} steady steps; {drains} bucket drains")
    return launches, times, profiles


def packed_path(torch, serial):
    """Phase 10: the packed raster (RenderConfig.packed_raster) on a third
    engine, settled and primed like phase 3's, over phase 3's camera
    sequence: 3 static frames, N_TIMED_PIPELINED timed static frames, the
    N_MOVING moving frames.  Every frame must launch K1 and K4 once and
    K2/K3 never, show no overflow, and equal phase 3's serial frame of its
    pose bit for bit (colour, depth, stats[:2]).  Returns (engine,
    launches, {"static_ms", "host_ms"}, the first static frame's stats)."""
    from differential_projection_voxel_renderer_tpu_torch.app.engine import (
        RenderConfig,
    )

    eng, t_world, t_prime = new_engine(
        torch, RenderConfig(WIDTH, HEIGHT, packed_raster=True))
    log(f"[10] packed engine: {eng.world.chunk_count()} chunks in "
        f"{t_world:.1f} s; prime: {len(eng.pool.by_pos)} meshes in "
        f"{t_prime:.1f} s")
    entry = count_entry_points(eng.renderer)

    def frame(ref, what):
        before = counters()
        res = eng.render_frame(dt=0.0)
        got = tuple(a - b for a, b in zip(counters(), before))
        if got != (1, 0, 0, 1):
            raise AssertionError(f"{what} launched K1-K4 {got}, expected "
                                 f"(1, 0, 0, 1)")
        return res, same_frame(torch, res, ref)

    def check(res, same, what):
        st = res.stats.cpu().numpy()
        if st[2] != 0 or st[3] != 0:
            raise AssertionError(f"{what}: overflow in stats {st}")
        if not bool(same):
            raise AssertionError(f"{what} differs from phase 3's serial "
                                 f"frame of its pose")
        return st

    static, moving = serial["static"], serial["moving"]
    torch.cuda.synchronize()
    reset_counters()
    for i in range(3):
        st = check(*frame(static, f"packed static frame {i}"),
                   f"packed static frame {i}")
        log(f"[10] packed static frame {i}: stats={st.tolist()}, equal to "
            f"phase 3's serial frame bit for bit; entry={dict(entry)}")
        if i == 0:
            stats0 = st
    ok = torch.ones((), dtype=torch.bool, device=eng.device)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    ev0.record()
    for _ in range(N_TIMED_PIPELINED):
        ok = ok & frame(static, "a timed packed static frame")[1]
    ev1.record()
    ev1.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / N_TIMED_PIPELINED
    dev_ms = ev0.elapsed_time(ev1) / N_TIMED_PIPELINED
    if not bool(ok):
        raise AssertionError("a timed packed static frame differs from the "
                             "serial frame")
    for i, (pos, target) in enumerate(moving_poses()):
        eng.camera.position = pos
        eng.camera.look_at(target)
        st = check(*frame(moving[i], f"packed moving frame {i}"),
                   f"packed moving frame {i}")
        log(f"[10] packed moving frame {i}: stats={st.tolist()}, equal to "
            f"phase 3's bit for bit; entry={dict(entry)}")
    torch.cuda.synchronize()
    launches = counters()
    frames = 3 + N_TIMED_PIPELINED + N_MOVING
    if launches != (frames, 0, 0, frames):
        raise AssertionError(f"launches {launches} for {frames} frames")
    if not entry.get("render_fused_insert"):
        raise AssertionError(f"no frame took render_fused_insert: {entry}")
    log(f"[10] packed path: {frames} frames, each equal to phase 3's serial "
        f"frame of its pose bit for bit; launches K1={launches[0]} "
        f"K2={launches[1]} K3={launches[2]} K4={launches[3]}, entry points "
        f"{entry}")
    return eng, launches, dict(static_ms=dev_ms, host_ms=host_ms), stats0


def occlusion_path(torch, serial_eng, serial, card):
    """Phase 12: exact occlusion.  A two-pass engine
    (RenderConfig(two_pass_near_quads=NEAR_QUADS)) and a temporal one
    (RenderConfig(temporal_hiz=True)), settled and primed like phase 3's,
    drive phase 3's camera sequence (3 static frames, the N_MOVING moving
    frames).  The counters are zeroed before each engine's sequence and read
    per frame: a two-pass frame launches K1 once and K2 twice, a temporal
    frame K1 and K2 once.  Every frame must equal phase 3's serial frame of
    its pose bit for bit (colour, depth, stats[:2]) and show no overflow.
    The temporal engine's first static frame takes the plain path and its
    second seeds the pyramid (stats[5] == 0 on both); later static frames
    cull (stats[5] > 0); moving frames never cull.  Then all three engines
    go back to the start pose and their static frames are timed in
    alternating blocks of N_TIMED_PIPELINED (serial, two-pass, temporal,
    temporal, two-pass, serial), each frame checked on the card.  Returns
    ({mode: launches (K1-K4) over its sequence}, {mode: [(events ms, host
    ms) per block]}, {mode: [stats[5] of the 3 static frames, then of each
    timed block's last frame]}, and 10 static frames of each mode under
    torch.profiler, {mode: profile_frames' result})."""
    import numpy as np

    from differential_projection_voxel_renderer_tpu_torch.app.engine import (
        RenderConfig,
    )

    engines = {}
    for mode, cfg in (("two-pass", dict(two_pass_near_quads=NEAR_QUADS)),
                      ("temporal", dict(temporal_hiz=True))):
        eng, t_world, t_prime = new_engine(
            torch, RenderConfig(WIDTH, HEIGHT, **cfg))
        engines[mode] = eng
        log(f"[12] {mode} engine: {eng.world.chunk_count()} chunks in "
            f"{t_world:.1f} s; prime: {len(eng.pool.by_pos)} meshes in "
            f"{t_prime:.1f} s")
    want = {"serial": (1, 1, 0, 0), "two-pass": (1, 2, 0, 0),
            "temporal": (1, 1, 0, 0)}
    static, moving = serial["static"], serial["moving"]

    def frame(mode, eng, ref, what):
        before = counters()
        res = eng.render_frame(dt=0.0)
        got = tuple(a - b for a, b in zip(counters(), before))
        if got != want[mode]:
            raise AssertionError(f"{what} launched K1-K4 {got}, expected "
                                 f"{want[mode]}")
        return res, same_culled_frame(torch, res, ref)

    def check(res, same, what):
        st = res.stats.cpu().numpy()
        if st[2] != 0 or st[3] != 0:
            raise AssertionError(f"{what}: overflow in stats {st}")
        if not bool(same):
            raise AssertionError(f"{what} differs from phase 3's serial "
                                 f"frame of its pose")
        return st

    launches, culled = {}, {}
    for mode, eng in engines.items():
        torch.cuda.synchronize()
        reset_counters()
        culled[mode] = []
        for i in range(3):
            st = check(*frame(mode, eng, static, f"{mode} static frame {i}"),
                       f"{mode} static frame {i}")
            culled[mode].append(int(st[5]))
            log(f"[12] {mode} static frame {i}: stats={st.tolist()}, equal "
                f"to phase 3's serial frame bit for bit")
        moving_culled = []
        for i, (pos, target) in enumerate(moving_poses()):
            eng.camera.position = pos
            eng.camera.look_at(target)
            st = check(*frame(mode, eng, moving[i],
                              f"{mode} moving frame {i}"),
                       f"{mode} moving frame {i}")
            moving_culled.append(int(st[5]))
        torch.cuda.synchronize()
        launches[mode] = counters()
        frames = 3 + N_MOVING
        if launches[mode] != tuple(w * frames for w in want[mode]):
            raise AssertionError(f"{mode}: launches {launches[mode]} for "
                                 f"{frames} frames")
        if mode == "temporal" and (culled[mode][:2] != [0, 0]
                                   or culled[mode][2] <= 0
                                   or any(moving_culled)):
            raise AssertionError(f"temporal hiz_culled: static "
                                 f"{culled[mode]}, moving {moving_culled}")
        log(f"[12] {mode}: {frames} frames, each equal to phase 3's serial "
            f"frame of its pose bit for bit; launches K1={launches[mode][0]}"
            f" K2={launches[mode][1]}; hiz_culled on the static frames "
            f"{culled[mode]}, on the moving frames {moving_culled}")

    # the static pose again, on all three engines, then timed blocks
    engines = dict(serial=serial_eng, **engines)
    for mode, eng in engines.items():
        eng.camera.position = np.array(START_POS, np.float32)
        eng.camera.look_at(np.array(START_TARGET, np.float32))
        for i in range(3):
            res = eng.render_frame(dt=0.0)
            if not bool(same_culled_frame(torch, res, static)):
                raise AssertionError(f"{mode} at the start pose again differs "
                                     f"from phase 3's static frame")
    times = {m: [] for m in engines}
    for mode in ("serial", "two-pass", "temporal", "temporal", "two-pass",
                 "serial"):
        eng = engines[mode]
        ok = torch.ones((), dtype=torch.bool, device=eng.device)
        torch.cuda.synchronize()
        before = counters()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        h0 = time.perf_counter()
        ev0.record()
        for _ in range(N_TIMED_PIPELINED):
            res = eng.render_frame(dt=0.0)
            ok = ok & same_culled_frame(torch, res, static)
        ev1.record()
        ev1.synchronize()
        times[mode].append((ev0.elapsed_time(ev1) / N_TIMED_PIPELINED,
                            (time.perf_counter() - h0) * 1e3
                            / N_TIMED_PIPELINED))
        got = tuple(a - b for a, b in zip(counters(), before))
        if not bool(ok) or got != tuple(N_TIMED_PIPELINED * w
                                        for w in want[mode]):
            raise AssertionError(f"a timed {mode} static frame differs from "
                                 f"phase 3's, or launched K1-K4 {got}")
        if mode != "serial":
            culled[mode].append(int(res.stats[5]))
    profiles = {mode: profile_frames(
        torch, lambda eng=engines[mode]: eng.render_frame(dt=0.0))
        for mode in ("two-pass", "temporal")}
    return launches, times, culled, profiles


def k2_init_checks(torch, raster, parity, pipeline, hiz, static_cam,
                   uploads, step_kw, full_rec, ref_frame, card):
    """Phase 12, K2 with an init frame against its plain version: the far
    pass of the wall scene at 128x128 (near pass WALL_NEAR quads) and of the
    vd12 static stream (near pass NEAR_QUADS), each on its near pass's
    frame; both must equal the plain version (bit for bit, or the
    boundary-verified gate) and their single-pass frames bit for bit.  Then
    K2 with the init frame against K2 without it on the same vd12 records
    (the far pass's, and the whole stream's ``full_rec``), a call, in runs
    of 20 and from a CUDA graph.  Returns (max |depth error|, timings dict,
    the far-pass records' item count)."""
    from differential_projection_voxel_renderer_tpu_torch.benches import (
        common,
    )

    err = 0.0
    gargs, gkw = parity.wall_scene("cuda")
    rkw = dict(height=128, width=128, tile_h=16, tile_w=128, out_h=128)
    cases = []
    c1, d1, _ = pipeline.render_step(*gargs[:2], WALL_NEAR, *gargs[3:],
                                     **gkw)
    rec = pipeline.render_step(*gargs, skip_quads=WALL_NEAR,
                               hiz_level1=hiz.build_max_pyramid(d1),
                               debug_return_records=True, **gkw)
    full = pipeline.render_step(*gargs, **gkw)[:2]
    cases.append(("wall scene 128x128", rec, c1, d1, full, rkw))
    quads, qw, total = uploads
    c1, d1, _ = pipeline._step_camf(quads, qw, torch.clamp(total,
                                                           max=NEAR_QUADS),
                                    static_cam, **step_kw)
    rec720 = pipeline._step_camf(quads, qw, total, static_cam,
                                 skip_quads=NEAR_QUADS,
                                 hiz_level1=hiz.build_max_pyramid(d1),
                                 debug_return_records=True, **step_kw)
    rkw720 = dict(height=HEIGHT, width=WIDTH, tile_h=16, tile_w=128,
                  out_h=HEIGHT)
    cases.append(("vd12 1280x720", rec720, c1, d1, ref_frame, rkw720))
    for name, rec, c1, d1, full, kw in cases:
        verdict, e, nmis, _ = k2_compare(
            torch, raster, parity, rec, kw["height"], kw["width"],
            init_color=c1, init_depth=d1)
        err = max(err, e)
        c, d = raster.rasterize_tiles(*rec, init_color=c1, init_depth=d1,
                                      **kw)
        if not (torch.equal(c, full[0]) and torch.equal(d, full[1])):
            raise AssertionError(f"K2 with the near frame ({name}) differs "
                                 f"from the single pass")
        log(f"[12] K2 with an init frame, {name} far pass "
            f"({int(rec[2].sum())} items on the near pass's frame): {verdict} "
            f"against its plain version ({nmis} colour mismatches); equal to "
            f"the single-pass frame bit for bit")
    init = dict(init_color=cases[1][2], init_depth=cases[1][3])
    t = {}
    # the far pass's records, and the whole static stream's (the frame the
    # same either way: the near items blend again onto their own depths)
    for what, r in (("far", rec720), ("full", full_rec)):
        for label, kw in (("init", dict(init, **rkw720)), ("no_init", rkw720)):
            def k2(r=r, kw=kw):
                return raster.rasterize_tiles(*r, **kw)
            t[f"{what}_{label}_ms"] = median_ms(k2)
            t[f"{what}_{label}_run_ms"] = median_ms(k2, batch=20)
            t[f"{what}_{label}_graph_ms"] = common.graph_ms(k2)
        log(f"[12] K2 on the vd12 {what}-pass records "
            f"({int(r[2].sum())} items), with the near pass's frame / "
            f"without: a call {t[f'{what}_init_ms']:.4f} / "
            f"{t[f'{what}_no_init_ms']:.4f} ms, in runs of 20 "
            f"{t[f'{what}_init_run_ms']:.4f} / "
            f"{t[f'{what}_no_init_run_ms']:.4f}, from a CUDA graph "
            f"{t[f'{what}_init_graph_ms']:.4f} / "
            f"{t[f'{what}_no_init_graph_ms']:.4f} (medians); {card}")
    return err, t, int(rec720[2].sum())


def margin_check(torch, pipeline, hiz, static_cam, uploads, step_kw,
                 ref_frame):
    """Phase 12: the Hi-Z cull's margin at vd12.  The temporal step on the
    static stream, culling against the pyramid of its own frame, and the
    two-pass step, each run with the port's margin
    (pipeline.HIZ_MARGIN_ULPS); the same culls recomputed on the step's
    stage A with the margin and with the reference's strict test.  Returns
    {mode: (quads the step culled, pixels that differ from the single
    pass, quads culled with the margin, quads culled strictly, quads on
    which the two tests differ)}."""
    quads, qw, total = uploads
    c, d, st, _ = pipeline._step_camf_hiz(
        quads, qw, total, static_cam, hiz.build_max_pyramid(ref_frame[1]),
        **step_kw)
    c2, d2, st2 = pipeline._step_camf(
        quads, qw, total, static_cam, **dict(step_kw, near_quads=NEAR_QUADS))
    valid, bbx, bby, dn, _ = pipeline._geom_camf(
        quads, qw, total, static_cam, width=step_kw["width"],
        height=step_kw["height"],
        backface_culling=step_kw["backface_culling"])
    _, d_near, _ = pipeline._step_camf(
        quads, qw, torch.clamp(total, max=NEAR_QUADS), static_cam, **step_kw)
    idx = torch.arange(quads.shape[0], device=quads.device)
    out = {}
    for mode, (cc, dd, ss), depth, mask in (
            ("temporal", (c, d, st), ref_frame[1], valid),
            ("two-pass", (c2, d2, st2), d_near, valid & (idx >= NEAR_QUADS))):
        h1 = hiz.build_max_pyramid(depth)
        margin, strict = (hiz.quads_occluded_exact(
            h1, bbx, bby, x, height=step_kw["height"],
            width=step_kw["width"]) & mask
            for x in (pipeline._ulps_below(dn, pipeline.HIZ_MARGIN_ULPS), dn))
        px = int(((cc != ref_frame[0]) | (dd != ref_frame[1])).sum())
        out[mode] = (int(ss[5]), px, int(margin.sum()), int(strict.sum()),
                     int((margin != strict).sum()))
    return out


def band_path(torch, eng, serial, card):
    """Phase 13: row bands and the camera batch on the phase-3 engine's
    pool.  The draw lists of phase 3's static pose and last moving pose
    (kept as chunk positions) become the batch of dp = 2 cameras.
    make_sharded_render with tp = 2 (360-row bands padded to 368) and tp =
    3 (240 rows, 15 tiles each): the counters are zeroed before and read
    after (K1 and K2 launch tp times a camera), and the stacked bands must
    equal phase 3's frame of each pose bit for bit (colour and depth).
    make_sharded_render_dp over the same cameras (the draw lists expanded
    with every face direction) must equal them too.  Then K2 with y0_px
    against its plain version on the last band of each split, and each
    band's K2 time (in runs of 20, and from a CUDA graph) beside the full
    frame's on the same stream.  Returns (launches {"tp=2", "tp=3", "dp"},
    {band: (runs ms, graph ms)}, max |depth error| of the band checks)."""
    import numpy as np

    from differential_projection_voxel_renderer_tpu_torch.parallel import (
        sharded_render as sr,
    )
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        parity,
        pipeline,
    )
    from differential_projection_voxel_renderer_tpu_torch.ops import raster

    cfg = eng.config
    vcap = cfg.visible_chunks_cap
    refs = [serial["static"], serial["moving"][-1]]
    visible = np.zeros((2, vcap), np.int32)
    nvis = np.zeros(2, np.int32)
    for i, pos in enumerate(serial["lists"]):
        slots, has = eng.pool.lookup_slots(pos)
        if not has.all():
            raise AssertionError("a chunk of phase 3's draw list left the "
                                 "pool")
        visible[i, :len(slots)] = slots
        nvis[i] = len(slots)
    most = max(int(eng.pool.counts[visible[i, :nvis[i]]].sum())
               for i in range(2))
    gather_cap = max(cfg.gather_cap, 1 << (most - 1).bit_length())
    caps = dict(gather_cap=gather_cap, render_cap=cfg.quads_cap,
                tile_k_cap=cfg.tile_k_cap)
    dev = eng.device
    vps = torch.from_numpy(np.stack([c[0] for c in serial["cams"]])).to(dev)
    cps = torch.from_numpy(np.stack([c[1] for c in serial["cams"]])).to(dev)
    args = (eng.pool.quads, torch.from_numpy(eng.pool.counts).to(dev),
            torch.from_numpy(eng.pool.positions).to(dev),
            torch.from_numpy(visible).to(dev),
            torch.from_numpy(nvis).to(dev), vps, cps)

    def same(i, color, depth):
        return (torch.equal(color, refs[i][0])
                and torch.equal(depth.view(torch.int32),
                                refs[i][1].view(torch.int32)))

    launches = {}
    for tp in (2, 3):
        fn = sr.make_sharded_render((2, tp), width=WIDTH, height=HEIGHT,
                                    device=dev, **caps)
        torch.cuda.synchronize()
        reset_counters()
        color, depth, count = fn(*args)
        torch.cuda.synchronize()
        launches[f"tp={tp}"] = counters()
        if launches[f"tp={tp}"] != (2 * tp, 2 * tp, 0, 0):
            raise AssertionError(f"tp={tp}: launches {launches[f'tp={tp}']}")
        for i in range(2):
            if not same(i, color[i], depth[i]):
                raise AssertionError(f"tp={tp}: camera {i}'s stacked bands "
                                     f"differ from phase 3's frame")
        bh = HEIGHT // tp
        log(f"[13] make_sharded_render dp=2 x tp={tp} (bands of {bh} rows, "
            f"K2 buffers of {-bh % 16 + bh}): "
            f"the stacked bands equal phase 3's static and last moving "
            f"frames bit for bit; launches K1={launches[f'tp={tp}'][0]} "
            f"K2={launches[f'tp={tp}'][1]}; counts (bands' sum / tp) "
            f"{count.tolist()} against the frames' "
            f"{[int(r[2][1]) for r in refs]} (no direction mask here)")
    streams = []
    ones = torch.ones((vcap, 6), dtype=torch.int32, device=dev)
    for i in range(2):
        sl = torch.from_numpy(visible[i]).to(dev)
        c6 = torch.where(torch.arange(vcap, device=dev)[:, None] < nvis[i],
                         eng.pool.counts6_dev[sl.long()], 0)
        streams.append(pipeline._expand_uploads_impl(
            eng.pool.quads, sl, c6, ones, args[2][sl.long()], gather_cap))
    fn, n = sr.make_sharded_render_dp(2, width=WIDTH, height=HEIGHT,
                                      render_cap=caps["render_cap"],
                                      tile_k_cap=caps["tile_k_cap"],
                                      device=dev)
    torch.cuda.synchronize()
    reset_counters()
    color, depth, stats = fn(*(torch.stack([s[k] for s in streams])
                               for k in range(3)), vps, cps)
    torch.cuda.synchronize()
    launches["dp"] = counters()
    if launches["dp"] != (2, 2, 0, 0) or not all(
            same(i, color[i], depth[i]) for i in range(2)):
        raise AssertionError(f"make_sharded_render_dp differs from phase 3's "
                             f"frames (launches {launches['dp']})")
    log(f"[13] make_sharded_render_dp over the 2 cameras: equal to phase 3's "
        f"frames bit for bit; launches K1={launches['dp'][0]} "
        f"K2={launches['dp'][1]}; stats {stats.tolist()}")

    # K2 with y0_px, and each band's time, on the static pose's stream
    quads, qw, total = streams[0]
    step_kw = dict(eng.renderer._bucket_kw(gather_cap),
                   render_cap=caps["render_cap"],
                   tile_k_cap=caps["tile_k_cap"])
    cam_f = eng.renderer._cam_dev(*serial["cams"][0])
    rkw = dict(height=HEIGHT, width=WIDTH, tile_h=16, tile_w=128)
    full = pipeline._step_camf(quads, qw, total, cam_f,
                               debug_return_records=True, **step_kw)
    from differential_projection_voxel_renderer_tpu_torch.benches import (
        common,
    )

    def times(k2):
        """(in runs of 20, from a CUDA graph) ms a call."""
        return median_ms(k2, batch=20), common.graph_ms(k2)

    band_ms = {"full frame": times(lambda: raster.rasterize_tiles(
        *full, out_h=HEIGHT, **rkw))}
    err = 0.0
    for tp in (2, 3):
        bh = HEIGHT // tp
        out_h = -bh % 16 + bh
        for b in range(tp):
            rec = pipeline._step_camf(quads, qw, total, cam_f, band_y0=b * bh,
                                      band_h=bh, debug_return_records=True,
                                      **step_kw)
            if b == tp - 1:
                verdict, e, nmis, padded = k2_compare(
                    torch, raster, parity, rec, HEIGHT, WIDTH, rows=bh,
                    y0_px=b * bh)
                err = max(err, e)
                log(f"[13] K2 with y0_px={b * bh} on a {bh}-row band "
                    f"({out_h}-row buffer, {int(rec[2].sum())} items): "
                    f"{verdict} against its plain version ({nmis} colour "
                    f"mismatches); pixels written in the padded rows: K2 "
                    f"{padded[0]}, its plain version {padded[1]}")
            band_ms[f"tp={tp} band {b}"] = times(
                lambda rec=rec, y0=b * bh, out_h=out_h: raster.rasterize_tiles(
                    *rec, out_h=out_h, y0_px=y0, **rkw))
    log("[13] K2 on the static pose's stream, ms a call in runs of 20 / from "
        "a CUDA graph: " + ", ".join(f"{k} {r:.4f} / {g:.4f}"
                                     for k, (r, g) in band_ms.items())
        + f"; {card}")
    return launches, band_ms, err


def fly_path(eng, path, ev, keep_frames=True):
    """app/flythrough.run_flythrough over ``path`` between the CUDA events
    ``ev``; each frame's (colour, depth, stats) as device copies, or None
    without ``keep_frames``."""
    from differential_projection_voxel_renderer_tpu_torch.app import (
        flythrough,
    )

    ev[0].record()
    out = [keep(r) if keep_frames else None
           for r in flythrough.run_flythrough(eng, path)]
    ev[1].record()
    return out


class Parts:
    """The parts of a phase: each runs with the launch counters zeroed
    before it and read after it (``launches[part]`` = (K1, K2, K3, K4)),
    timed by the host clock around work that ends in a synchronise
    (``secs[part]``)."""

    def __init__(self, torch, phase: str):
        self.torch, self.phase = torch, phase
        self.launches, self.secs = {}, {}

    def run(self, part, fn):
        self.torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        self.secs[part] = time.perf_counter() - t0
        self.launches[part] = counters()
        return out

    def need(self, part, *want):
        """Each of K1, K2, K3 launched exactly ``want[i]`` times, or at
        least once where ``want[i]`` is "+"."""
        got = self.launches[part]
        for n, w in zip(got, want):
            if not (n > 0 if w == "+" else n == w):
                raise AssertionError(f"[{self.phase}] {part}: launches "
                                     f"{got}, wanted {want}")


def pool_snapshot(torch, pool):
    """Everything of a QuadPool that a later frame or slot choice reads:
    device rows and counts mirror (copies), host tables, free list, used
    mask."""
    return dict(quads=pool.quads.clone(), c6=pool.counts6_dev.clone(),
                counts=pool.counts.copy(), counts6=pool.counts6.copy(),
                positions=pool.positions.copy(), by_pos=dict(pool.by_pos),
                free=list(pool._free), used=pool._used.copy(),
                drops=pool.overflow_drops)


def same_pool_snapshot(torch, a, b) -> bool:
    import numpy as np

    return all(torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
               else np.array_equal(a[k], b[k])
               if isinstance(a[k], np.ndarray) else a[k] == b[k]
               for k in a)


def shared_chunks_equal(torch, pa, pb) -> tuple[int, int]:
    """(chunks in both pools, of them those with the same rows up to their
    count, host counts and device counts mirror)."""
    import numpy as np

    keys = sorted(set(pa.by_pos) & set(pb.by_pos))
    sa = np.array([pa.by_pos[k] for k in keys], np.int64)
    sb = np.array([pb.by_pos[k] for k in keys], np.int64)
    dev = pa.quads.device
    ia, ib = torch.from_numpy(sa).to(dev), torch.from_numpy(sb).to(dev)
    n = torch.from_numpy(pa.counts[sa].astype(np.int64)).to(dev)
    live = torch.arange(pa.qcap, device=dev)[None, :] < n[:, None]
    rows = (torch.where(live, pa.quads[ia], 0)
            == torch.where(live, pb.quads[ib], 0)).all(1)
    mirror = (pa.counts6_dev[ia] == pb.counts6_dev[ib]).all(1)
    host = torch.from_numpy((pa.counts6[sa] == pb.counts6[sb]).all(1)).to(dev)
    return len(keys), int((rows & mirror & host).sum())


def same_pool_content(torch, pa, pb) -> bool:
    """The two pools hold the same chunks with the same rows (up to each
    chunk's count), host counts and device counts mirror; slot numbers may
    differ."""
    if set(pa.by_pos) != set(pb.by_pos):
        return False
    shared, equal = shared_chunks_equal(torch, pa, pb)
    return equal == shared


def app_path(torch, eng3, serial, static, card):
    """Phase 14: the application surface on the card.  The launch counters
    are zeroed before each part and read after it.

    - a fresh engine of phase 3's configuration, settled and primed with
      prime_all: warm_buckets(), one frame at the start pose (equal to
      phase 3's static frame bit for bit: colour, depth, stats), then
      warm_streaming() (the pool unchanged, rows and mirror included);
    - run_flythrough over default_path(FLY_KEYS) on it, frames a second by
      CUDA events and by the host clock; K1 and K2 once a frame;
    - the same keys on a second engine with stale_streaming (warmed with
      warm_buckets(pipelined=True): K3 launches), its frames against the
      serial ones (how many differ, how many chunks were meshed late),
      then, the worlds settled at the last key, two frames with the camera
      held on each: the second pair equal bit for bit and the pools equal
      chunk by chunk; the same for a serial and a stale engine primed with
      prime() only, whose flight streams visible chunks (some frame must
      differ);
    - toggle_shading() twice on the phase-3 engine: the unshaded frame has
      the shaded one's coverage and depth and differs at covered pixels,
      the frame after toggling back equals the shaded one bit for bit;
    - run_production_parity on phase 3's vd12 static uploads at 1280x720;
    - graft_entry.entry() once (shapes, stats, non-sky pixels) and
      dryrun_multichip(4) and (8): (dp, tp) = (2, 2) and (2, 4);
    - the demo's main into a temporary PPM at 1280x720, view distance 6:
      the file is the header and 3 W H bytes.

    Returns (launches {part: (K1, K2, K3, K4)}, {part: seconds},
    flythrough frames a second {"events", "host", "prime host"}, {"prime_all",
    "prime": (stale frames that differ, chunks meshed late)}, the parity
    verdict, the flights phase 15 compares with: {"primed": the primed
    serial flight's frames, "serial": (the prime()-only serial engine, held
    at the last key), "stale": the prime()-only stale flight's frames})."""
    import tempfile

    import numpy as np

    from differential_projection_voxel_renderer_tpu_torch import graft_entry
    from differential_projection_voxel_renderer_tpu_torch.app import (
        flythrough,
    )
    from differential_projection_voxel_renderer_tpu_torch.examples import (
        render_demo,
    )
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        parity,
    )

    parts = Parts(torch, "14")
    launches, secs, timed, need = (parts.launches, parts.secs, parts.run,
                                   parts.need)

    # warm-ups, in benches/flythrough_bench.py's order
    eng, t_world, t_prime = timed("settle + prime_all", lambda: new_engine(
        torch, prime_all=True, pool_slots=APP_POOL_SLOTS))
    timed("warm_buckets", eng.warm_buckets)
    need("warm_buckets", "+", "+", 0)
    res = timed("frame", lambda: eng.render_frame(dt=0.0))
    need("frame", 1, 1, 0)
    ref = serial["static"]
    if not (torch.equal(res.color, ref[0]) and torch.equal(
            res.depth.view(torch.int32), ref[1].view(torch.int32))
            and torch.equal(res.stats, ref[2])):
        raise AssertionError("[14] the frame after warm_buckets differs from "
                             "phase 3's static frame")
    before = pool_snapshot(torch, eng.pool)
    timed("warm_streaming", eng.warm_streaming)
    need("warm_streaming", "+", "+", 0)
    if not same_pool_snapshot(torch, before, pool_snapshot(torch, eng.pool)):
        raise AssertionError("[14] warm_streaming changed the pool")
    del before
    log(f"[14] fresh engine: world settled in {t_world:.2f} s, prime_all "
        f"{len(eng.pool.by_pos)} meshes in {t_prime:.2f} s; warm_buckets "
        f"{secs['warm_buckets']:.3f} s ({len(eng.renderer.gather_buckets)} "
        f"buckets, launches {launches['warm_buckets']}), the frame "
        f"{secs['frame']:.3f} s and equal to phase 3's static frame bit for "
        f"bit, warm_streaming {secs['warm_streaming']:.3f} s (launches "
        f"{launches['warm_streaming']}), the pool unchanged; {card}")

    # the flythrough
    path = flythrough.default_path(FLY_KEYS)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def fly(e):
        return fly_path(e, path, ev)

    frames = timed("flythrough", lambda: fly(eng))
    need("flythrough", FLY_KEYS, FLY_KEYS, 0)
    fps = dict(events=FLY_KEYS / (ev[0].elapsed_time(ev[1]) / 1e3),
               host=FLY_KEYS / secs["flythrough"])
    log(f"[14] run_flythrough over default_path({FLY_KEYS}): "
        f"{fps['events']:.2f} frames/s between CUDA events, "
        f"{fps['host']:.2f} frames/s by the host clock; launches "
        f"{launches['flythrough']}; {len(eng.pool.by_pos)} meshes after; "
        f"stats of the last frame {frames[-1][2].tolist()}; {card}")

    # the stale pool: against the primed engine, and on a pair primed with
    # prime() only, whose flight streams visible chunks
    def stale_pair(label, ser, ser_frames, prime_all):
        st, _, _ = new_engine(torch, prime_all=prime_all,
                              pool_slots=APP_POOL_SLOTS)
        st.stale_streaming = True
        late = []
        apply = st._apply_stale_stash

        def counted():
            late.append(len(st._stale_stash))
            apply()

        st._apply_stale_stash = counted
        part = f"warm_buckets(pipelined), {label}"
        timed(part, lambda: st.warm_buckets(pipelined=True))
        need(part, "+", "+", "+")
        st.render_frame(dt=0.0)
        part = f"stale flythrough, {label}"
        sframes = timed(part, lambda: fly(st))
        need(part, FLY_KEYS, FLY_KEYS, 0)
        flights[f"stale {label}"] = sframes
        differ = sum(1 for a, b in zip(ser_frames, sframes)
                     if not (torch.equal(a[0], b[0])
                             and torch.equal(a[1], b[1])))
        n_late = sum(late[-FLY_KEYS:])
        held = []
        for e in (ser, st):
            while e.world.update(e.camera.position):
                pass
            held.append([e.render_frame(dt=0.0) for _ in range(2)])
        if st._stale_stash:
            raise AssertionError(f"[14] {label}: the stale stash did not "
                                 f"drain")
        a, b = held[0][1], held[1][1]
        if not (torch.equal(a.color, b.color) and torch.equal(
                a.depth.view(torch.int32), b.depth.view(torch.int32))
                and torch.equal(a.stats, b.stats)):
            raise AssertionError(f"[14] {label}: the stale engine's settle "
                                 f"frame differs from the serial engine's")
        if not same_pool_content(torch, ser.pool, st.pool):
            raise AssertionError(f"[14] {label}: the stale and serial pools "
                                 f"differ")
        log(f"[14] stale pool ({label}) over the same {FLY_KEYS} keys: "
            f"{n_late} chunks meshed one frame late, {differ} frames differ "
            f"from the serial engine's; "
            f"{FLY_KEYS / secs[part]:.2f} stale frames/s by the host clock; "
            f"warm_buckets(pipelined=True) launches "
            f"{launches[f'warm_buckets(pipelined), {label}']}; held at the "
            f"last key, the second frame equal to the serial engine's bit "
            f"for bit, the pools equal chunk by chunk "
            f"({len(st.pool.by_pos)} entries; {st.world.chunk_count()} "
            f"chunks loaded); {card}")
        return differ, n_late

    flights = {"primed": frames}
    stale = {"prime_all": stale_pair("prime_all", eng, frames, True)}
    ser, _, _ = new_engine(torch, pool_slots=APP_POOL_SLOTS)
    ser.render_frame(dt=0.0)
    frames = timed("flythrough, prime", lambda: fly(ser))
    need("flythrough, prime", FLY_KEYS, FLY_KEYS, 0)
    fps["prime host"] = FLY_KEYS / secs["flythrough, prime"]
    log(f"[14] run_flythrough over default_path({FLY_KEYS}) after prime() "
        f"only (visible chunks stream in): {fps['prime host']:.2f} frames/s "
        f"by the host clock; {len(ser.pool.by_pos)} meshes after; {card}")
    stale["prime"] = stale_pair("prime", ser, frames, False)
    if not stale["prime"][0]:
        raise AssertionError("[14] no stale frame differed: the flight "
                             "streamed no visible chunk")
    flights = dict(primed=flights["primed"], serial=ser,
                   stale=flights["stale prime"])
    del eng, frames

    # the shading toggle on the phase-3 engine
    def shading():
        base = keep(eng3.render_frame(dt=0.0))
        off = eng3.toggle_shading()
        flat = keep(eng3.render_frame(dt=0.0))
        on = eng3.toggle_shading()
        back = keep(eng3.render_frame(dt=0.0))
        return base, flat, back, (off, on)

    base, flat, back, toggles = timed("shading toggle", shading)
    need("shading toggle", 3, 3, 0)
    from differential_projection_voxel_renderer_tpu_torch.ops.raster import (
        SKY_I32,
    )
    cover = base[0] != SKY_I32
    if not (toggles == (False, True)
            and torch.equal(cover, flat[0] != SKY_I32)
            and torch.equal(base[1].view(torch.int32),
                            flat[1].view(torch.int32))
            and bool((base[0] != flat[0])[cover].any())
            and all(torch.equal(x, y) for x, y in zip(base, back))):
        raise AssertionError(f"[14] the shading round trip failed "
                             f"({toggles})")
    log(f"[14] toggle_shading twice on the phase-3 engine: the unshaded frame "
        f"has the shaded frame's coverage and depth, "
        f"{int((base[0] != flat[0]).sum())} of {int(cover.sum())} covered "
        f"pixels change colour; the frame after toggling back equals the "
        f"shaded one bit for bit")
    del base, flat, back

    # production parity
    uploads, vp0, cp0 = static
    verdict = timed("production parity", lambda: parity.run_production_parity(
        eng3.renderer, uploads, vp0, cp0))
    need("production parity", 2, 1, 0)
    if not verdict.startswith(("exact", "boundary-ok")):
        raise AssertionError(f"[14] production parity: {verdict}")
    log(f"[14] PARITY {verdict} ({secs['production parity']:.2f} s)")

    # the graft entry points
    def entry():
        fn, args = graft_entry.entry()
        return fn(*args), int(args[2])

    (color, depth, st), total = timed("entry", entry)
    need("entry", 1, 1, 0)
    st = st.tolist()
    if not (color.shape == depth.shape == (HEIGHT, WIDTH)
            and st[0] == total and 0 < st[1] <= total and st[2] == 0
            and nonsky(color) > 0):
        raise AssertionError(f"[14] graft_entry.entry(): stats {st}")
    log(f"[14] graft_entry.entry(): {tuple(color.shape)} frame, stats {st}, "
        f"{nonsky(color)} non-sky pixels, {secs['entry']:.2f} s")
    for n in (4, 8):
        part = f"dryrun_multichip({n})"
        timed(part, lambda n=n: graft_entry.dryrun_multichip(n))
        need(part, "+", "+", 0)
        log(f"[14] {part}: (dp, tp) = {graft_entry.make_mesh(n)}, every check "
            f"passed (the stacked bands equal the single render_step frame "
            f"bit for bit), launches {launches[part]}, {secs[part]:.2f} s")

    # the demo
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "frame.ppm")
        fb = timed("demo", lambda: render_demo.main(
            [out, "--vd", "6", "--width", str(WIDTH), "--height",
             str(HEIGHT)]))
        size = os.path.getsize(out)
    need("demo", 1, 1, 0)
    header = len(f"P6\n{WIDTH} {HEIGHT}\n255\n")
    if size != header + 3 * WIDTH * HEIGHT or fb.width != WIDTH:
        raise AssertionError(f"[14] the demo wrote {size} bytes")
    log(f"[14] demo: {size} bytes ({header} of header + 3 x {WIDTH} x "
        f"{HEIGHT}), {secs['demo']:.2f} s with its world and meshing")
    return launches, secs, fps, stale, verdict, flights


# ------------------------------------------------------------- resident


def same_frame_bits(torch, a, b) -> bool:
    """Colour and depth of two frames ((colour, depth, ...) tuples) equal
    bit for bit."""
    return torch.equal(a[0], b[0]) and torch.equal(a[1].view(torch.int32),
                                                   b[1].view(torch.int32))


def resident_path(torch, serial, flights, card):
    """Phase 15: the resident superset stream (Engine(resident_stream=True))
    at the headline scene, RenderConfig's defaults widened by the mode, with
    16384-slot pools.  The launch counters are zeroed before each part and
    read after it.

    - A resident engine primed with prime_all: warm_resident (the pool
      unchanged, rows and mirror included), the start pose's frame (equal
      to phase 3's static frame bit for bit), then default_path(FLY_KEYS):
      every frame equal to phase 14's primed serial flight bit for bit
      (colour and depth; the stats count the superset stream), no
      fallback, at least one rebuild (a cell crossing), K1 and K2 once a
      frame.
    - A resident engine primed with prime() only over the same keys: the
      frames that differ from phase 14's stale engine's (primed the same),
      appends and fused inserts (each at least one); then, the camera held
      at the last key and the world settled, frames until the stash
      drains, invalidate_resident() and one frame: equal to phase 14's
      serial engine's bit for bit, every chunk of its pool in the resident
      pool (the chunks of both with equal rows counted).
    - K1 and K2 on the primed engine's last stream at the resident shapes
      (the 262144-quad bucket, compaction on, item cap 131072) against
      their plain versions bit for bit, their device time from a CUDA graph
      and their bound.
    - run_resident_append_selftest, run_fused_insert_selftest and
      run_pipelined_selftest on the card: each "exact".
    - Frames a second, resident against serial, primed and streaming, in
      alternating turns on fresh engines (FLY_TURNS turns each), by CUDA
      events and the host clock; 10 profiled resident moving frames.

    Returns (launches {part: (K1, K2, K3, K4)}, {part: seconds}, the
    kernels' numbers at the resident shapes)."""
    import numpy as np

    from differential_projection_voxel_renderer_tpu_torch.app import (
        flythrough,
    )
    from differential_projection_voxel_renderer_tpu_torch.benches import (
        common,
    )
    from differential_projection_voxel_renderer_tpu_torch.benches import (
        kernel_cost_sim as kcs,
    )
    from differential_projection_voxel_renderer_tpu_torch.ops import (
        geometry,
        raster,
    )
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        parity,
        pipeline,
    )

    parts = Parts(torch, "15")
    timed, need = parts.run, parts.need
    path = flythrough.default_path(FLY_KEYS)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def fly(e, keep_frames=True):
        return fly_path(e, path, ev, keep_frames)

    def count_rebuilds(e):
        """Wrap the engine's stream rebuild: each build appends (cell,
        chunks, quads)."""
        builds = []
        build = e._rebuild_resident

        def counted(cell):
            ok = build(cell)
            builds.append((cell, e._res_n, e._res_total) if ok else None)
            return ok
        e._rebuild_resident = counted
        return builds

    # the primed flight
    eng, t_world, t_prime = timed("settle + prime_all", lambda: new_engine(
        torch, prime_all=True, pool_slots=APP_POOL_SLOTS, resident=True))
    cfg = eng.config
    if not (eng.resident_stream and cfg.tile_k_cap >= 131072
            and cfg.visible_chunks_cap >= 1024):
        raise AssertionError(f"[15] the resident configuration: {cfg}")
    before = pool_snapshot(torch, eng.pool)
    builds = count_rebuilds(eng)
    timed("warm_resident", eng.warm_resident)
    need("warm_resident", 3, 3, 0)
    if not same_pool_snapshot(torch, before, pool_snapshot(torch, eng.pool)):
        raise AssertionError("[15] warm_resident changed the pool")
    del before
    res = timed("frame", lambda: eng.render_frame(dt=0.0))
    need("frame", 1, 1, 0)
    if not same_frame_bits(torch, (res.color, res.depth), serial["static"]):
        raise AssertionError("[15] the resident start-pose frame differs "
                             "from phase 3's static frame")
    log(f"[15] primed resident engine: world settled in {t_world:.2f} s, "
        f"prime_all {len(eng.pool.by_pos)} meshes in {t_prime:.2f} s; "
        f"gather cap {cfg.gather_cap}, buckets "
        f"{eng.renderer.gather_buckets}, item cap {cfg.tile_k_cap}, "
        f"{cfg.visible_chunks_cap} draw-list slots; warm_resident "
        f"{parts.secs['warm_resident']:.3f} s, launches "
        f"{parts.launches['warm_resident']}, the pool unchanged; the stream "
        f"built at cell {builds[0][0]}: {builds[0][1]} chunks, "
        f"{builds[0][2]} quads; the start-pose frame "
        f"{parts.secs['frame']:.3f} s and equal to phase 3's static frame "
        f"bit for bit (stats {res.stats.tolist()} against "
        f"{serial['static'][2].tolist()}); {card}")
    n_built = len(builds)
    frames = timed("primed flight", lambda: fly(eng))
    need("primed flight", FLY_KEYS, FLY_KEYS, 0)
    primed_ms = ev[0].elapsed_time(ev[1]) / FLY_KEYS
    rebuilds = builds[n_built:]
    if None in rebuilds or not eng.resident_stream:
        raise AssertionError("[15] the primed resident flight fell back")
    differ = [(i, a[2].tolist(), b[2].tolist(),
               int(((a[0] != b[0]) | (a[1] != b[1])).sum()))
              for i, (a, b) in enumerate(zip(frames, flights["primed"]))
              if not same_frame_bits(torch, a, b)]
    if differ:
        raise AssertionError(f"[15] primed resident frames differ from "
                             f"phase 14's primed serial flight: (frame, "
                             f"resident stats, serial stats, pixels) "
                             f"{differ}")
    if not rebuilds:
        raise AssertionError("[15] the primed flight crossed no chunk cell")
    more = [int(a[2][1]) - int(b[2][1])
            for a, b in zip(frames, flights["primed"])]
    dropped = ([int(f[2][3]) for f in frames],
               [int(f[2][3]) for f in flights["primed"]])
    log(f"[15] primed resident flight over default_path({FLY_KEYS}): every "
        f"frame equal to phase 14's primed serial flight bit for bit "
        f"(colour and depth); {len(rebuilds)} rebuilds (cell, chunks, "
        f"quads) {rebuilds}; {eng._res_appends} appends, "
        f"{eng._res_fused_inserts} fused inserts; the superset rasterizes "
        f"{min(more)}..{max(more)} more quads a frame than the serial path; "
        f"bin_overflow (quads the binning drops) {min(dropped[0])}.."
        f"{max(dropped[0])} a frame, the serial flight's {min(dropped[1])}.."
        f"{max(dropped[1])}; "
        f"launches {parts.launches['primed flight']} "
        f"({parts.launches['primed flight'][0] / FLY_KEYS:.2f} K1 and "
        f"{parts.launches['primed flight'][1] / FLY_KEYS:.2f} K2 a frame); "
        f"{1e3 / primed_ms:.2f} frames/s between CUDA events, "
        f"{FLY_KEYS / parts.secs['primed flight']:.2f} by the host clock; "
        f"{card}")
    del frames

    # the streaming flight
    st, _, _ = timed("settle + prime", lambda: new_engine(
        torch, pool_slots=APP_POOL_SLOTS, resident=True))
    st_builds = count_rebuilds(st)
    st.render_frame(dt=0.0)
    frames = timed("streaming flight", lambda: fly(st))
    need("streaming flight", FLY_KEYS, FLY_KEYS, 0)
    if None in st_builds or not st.resident_stream:
        raise AssertionError("[15] the streaming resident flight fell back")
    flight_riders = (st._res_appends, st._res_fused_inserts)
    differ = sum(1 for a, b in zip(frames, flights["stale"])
                 if not same_frame_bits(torch, a, b))
    log(f"[15] streaming resident flight (prime() only) over the same keys: "
        f"{differ} of {FLY_KEYS} frames differ from phase 14's stale "
        f"engine's; {flight_riders[0]} appends, {flight_riders[1]} fused "
        f"inserts (a batch rides the next frame only when that frame stays "
        f"in the cell), {len(st_builds) - 1} rebuilds after the first; "
        f"{len(st._stale_stash)} chunks left in the stash; "
        f"{FLY_KEYS / parts.secs['streaming flight']:.2f} frames/s by the "
        f"host clock; {card}")
    del frames

    def settle():
        while st.world.update(st.camera.position):
            pass
        # the first frame takes the settled world's chunks into the stash
        n = 1
        st.render_frame(dt=0.0)
        while st._stale_stash and n < SETTLE_FRAMES:
            st.render_frame(dt=0.0)
            n += 1
        st.render_frame(dt=0.0)
        st.invalidate_resident()
        return n, st.render_frame(dt=0.0)

    n_settle, held = timed("settle", settle)
    if st._stale_stash:
        raise AssertionError(f"[15] the stash did not drain in "
                             f"{SETTLE_FRAMES} frames")
    if not (st._res_appends and st._res_fused_inserts
            and st.resident_stream):
        raise AssertionError(f"[15] the streaming engine made "
                             f"{st._res_appends} appends and "
                             f"{st._res_fused_inserts} fused inserts")
    ser = flights["serial"]
    ref = ser.render_frame(dt=0.0)
    if not same_frame_bits(torch, (held.color, held.depth),
                           (ref.color, ref.depth)):
        raise AssertionError("[15] the settled resident frame differs from "
                             "the serial engine's")
    if not set(ser.pool.by_pos) <= set(st.pool.by_pos):
        raise AssertionError("[15] a chunk of the serial pool is missing "
                             "from the resident pool")
    shared, equal = shared_chunks_equal(torch, ser.pool, st.pool)
    log(f"[15] held at the last key: the stash drained in {n_settle} frames "
        f"({parts.secs['settle']:.2f} s; {st._res_appends} appends and "
        f"{st._res_fused_inserts} fused inserts since the start, launches "
        f"{parts.launches['settle']}), then invalidate_resident() and "
        f"the rebuilt frame equal to the serial engine's bit for bit (stats "
        f"{held.stats.tolist()} against {ref.stats.tolist()}); every chunk "
        f"of the serial pool ({len(ser.pool.by_pos)}) in the resident pool "
        f"({len(st.pool.by_pos)}); {equal} of the {shared} shared chunks "
        f"with equal rows, host counts and counts mirror")
    del st, ser, flights, held, ref

    # K1 and K2 at the resident shapes, on the primed engine's last stream
    r = eng.renderer
    q, w = eng._res_uploads
    bucket = int(q.shape[0])
    big = r.gather_buckets[-1]
    if bucket < big:
        # the stream's own bucket is smaller: the kernels are held at the
        # largest bucket's shapes with the stream padded
        q = torch.cat([q, q.new_zeros(big - bucket)])
        w = torch.cat([w, w.new_zeros((3, big - bucket))], 1)
    total = eng._res_total - (eng._res_pending[2] if eng._res_pending
                              else 0)
    total_t = torch.tensor(total, dtype=torch.int32, device=eng.device)
    cam = r._cam_dev(eng.camera.view_projection_matrix(),
                     eng.camera.position)
    vp, cp = pipeline._unpack_cam(cam)
    gkw = dict(width=WIDTH, height=HEIGHT)
    a1 = (q, w, total_t, vp, cp)
    n_valid, n_sub, k1_err = k1_compare(torch, geometry, a1, gkw)
    step_kw = r._bucket_kw(big)
    rec = pipeline._step_camf(q, w, total_t, cam, debug_return_records=True,
                              **step_kw)
    rkw = dict(height=HEIGHT, width=WIDTH, tile_h=16, tile_w=128,
               out_h=HEIGHT)
    c1, d1 = raster.rasterize_tiles(*rec, **rkw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c2, d2 = raster.rasterize_tiles_plain(*rec, **rkw)
    torch.cuda.synchronize()
    k2_plain = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(c1, c2) and torch.equal(d1, d2)):
        raise AssertionError("[15] K2 differs from its plain version at the "
                             "resident shapes")
    fin = torch.isfinite(d1) & torch.isfinite(d2)
    k2_err = float((d1 - d2).abs()[fin].max()) if bool(fin.any()) else 0.0
    counts = rec[2]

    def k1():
        return geometry.project_cull(*a1, **gkw)

    def k2():
        return raster.rasterize_tiles(*rec, **rkw)

    kern = dict(bucket=bucket, shape=big, quads=total, valid=n_valid,
                render_cap=step_kw["render_cap"],
                tile_k_cap=step_kw["tile_k_cap"],
                items=int(counts.sum()), k1_err=k1_err, k2_err=k2_err,
                k1_graph_ms=common.graph_ms(k1),
                k2_graph_ms=common.graph_ms(k2),
                k1_plain_ms=median_ms(lambda: geometry.project_cull_plain(
                    *a1, **gkw), reps=5), k2_plain_ms=k2_plain)
    kern["k1_bound_ms"], kern["k1_bound_by"] = bound(*k1_work(a1, k1()))
    boxes = kcs.item_boxes((q, w, total_t, cam), step_kw, rec)
    k2_bytes, k2_ops, _, _, _, k2_walk = kcs.k2_work(rec, boxes, HEIGHT,
                                                     WIDTH)
    kern["k2_bound_ms"], kern["k2_bound_by"] = bound(k2_bytes, k2_ops)
    # K2 on the serial path's records at the same camera, for comparison:
    # a fresh primed serial engine's frustum draw list there
    ser, _, _ = new_engine(torch, prime_all=True, pool_slots=APP_POOL_SLOTS)
    ser.camera.position = eng.camera.position.copy()
    ser.camera.look_at(path[-1].target)
    ser.render_frame(dt=0.0)
    sq, sw, st_ = ser.renderer.prepare_uploads(
        ser.pool.quads, ser._last_visible_slots, ser._last_counts_sel,
        ser._last_positions_sel, dir_mask=ser._last_dir_mask)
    srec = pipeline._step_camf(sq, sw, st_, cam, debug_return_records=True,
                               **ser.renderer._bucket_kw(int(sq.shape[0])))
    kern["k2_serial_graph_ms"] = common.graph_ms(
        lambda: raster.rasterize_tiles(*srec, **rkw))
    kern["serial_items"] = int(srec[2].sum())
    serial_quads = int(st_)
    del ser, sq, sw, st_, srec
    log(f"[15] K1 and K2 at the resident shapes (the primed engine's last "
        f"stream: {total} quads in the {bucket} bucket"
        + (f", padded to {big}" if bucket < big else "")
        + f"; compaction to {step_kw['render_cap']}, item cap "
        f"{step_kw['tile_k_cap']}): K1 equal to its plain version on all "
        f"five outputs and both counts ({n_valid} valid, {n_sub} sub-pixel), "
        f"K2 equal to its plain version bit for bit on {kern['items']} items "
        f"(at most {int(counts.max())} in a tile, the longest walk "
        f"{k2_walk}); from a CUDA graph K1 {kern['k1_graph_ms']:.4f} ms "
        f"(bound {kern['k1_bound_ms']:.5f}, {kern['k1_bound_by']}), K2 "
        f"{kern['k2_graph_ms']:.4f} ms (bound {kern['k2_bound_ms']:.5f}, "
        f"{kern['k2_bound_by']}: {k2_bytes} bytes, {k2_ops} ops), K2 on the "
        f"serial path's records at the same camera "
        f"{kern['k2_serial_graph_ms']:.4f} ms ({kern['serial_items']} "
        f"items, {serial_quads} quads); plain "
        f"versions K1 {kern['k1_plain_ms']:.4f} ms (median of 5), K2 "
        f"{k2_plain:.1f} ms (one call); {card}")
    del rec, c1, d1, c2, d2, boxes

    # the three self-tests on the card
    def selftests():
        return {name: getattr(parity, f"run_{name}_selftest")(
                    device=eng.device)
                for name in ("resident_append", "fused_insert", "pipelined")}

    verdicts = timed("self-tests", selftests)
    need("self-tests", "+", "+", "+")
    if set(verdicts.values()) != {"exact"}:
        raise AssertionError(f"[15] self-tests: {verdicts}")
    log(f"[15] self-tests on the card: {verdicts} "
        f"({parts.secs['self-tests']:.2f} s, launches "
        f"{parts.launches['self-tests']})")

    # frames a second, resident against serial, in alternating turns
    fps = {}
    for mode, primed in (("primed", True), ("streaming", False)):
        fps[mode] = {"resident": [], "serial": []}
        for turn in range(FLY_TURNS):
            for kind in ("resident", "serial"):
                e, _, _ = new_engine(torch, prime_all=primed,
                                     pool_slots=APP_POOL_SLOTS,
                                     resident=kind == "resident")
                if primed and kind == "resident":
                    e.warm_resident()
                elif primed:
                    e.warm_buckets()
                    e.render_frame(dt=0.0)
                    e.warm_streaming()
                e.render_frame(dt=0.0)
                part = f"{mode} {kind} turn {turn}"
                timed(part, lambda e=e: fly(e, keep_frames=False))
                need(part, FLY_KEYS, FLY_KEYS, 0)
                if kind == "resident" and not e.resident_stream:
                    raise AssertionError(f"[15] {part} fell back")
                fps[mode][kind].append(
                    (FLY_KEYS / (ev[0].elapsed_time(ev[1]) / 1e3),
                     FLY_KEYS / parts.secs[part]))
                del e
        log(f"[15] {mode} flight over default_path({FLY_KEYS}), frames/s "
            f"(CUDA events / host clock) in alternating turns on fresh "
            f"engines: " + "; ".join(
                f"{kind} " + ", ".join(f"{a:.2f} / {b:.2f}" for a, b in runs)
                for kind, runs in fps[mode].items()) + f"; {card}")

    # where a resident moving frame's device time goes
    keys = iter(flythrough.default_path(11))

    def moving_frame():
        key = next(keys)
        eng.camera.position = np.asarray(key.position, np.float32)
        eng.camera.look_at(key.target)
        return eng.render_frame(dt=0.0)

    log_profile("15", "resident moving frame (default_path(11) keys 1-10)",
                profile_frames(torch, moving_frame), primed_ms, card)
    return parts.launches, parts.secs, kern


# ------------------------------------------------------------- binning


def binning_path(torch, primed, card):
    """Phase 18: the binnings on the flights where they dropped visible
    quads, engines primed with prime_all like phase 14's (16384-slot
    pools), each part with the launch counters zeroed before and read
    after it.

    - A packed engine (RenderConfig(packed_raster=True)) over
      default_path(FLY_KEYS): bin_overflow (stats[3]) 0 on every key and
      every frame equal to phase 14's primed serial flight (``primed``) bit
      for bit (colour and depth), K1 and K4 once a frame, K2 and K3 never.
      With the reference's packed binning (one class of 512 big quads) it
      dropped up to 157 quads a key and changed up to 35089 pixels
      (benches/big_quad_cap.py on an H100).
    - A serial and a resident engine over default_path(LONG_KEYS):
      stats[3] 0 on every key of both and every resident frame equal to the
      serial frame of its key bit for bit, K1 and K2 once a frame.  With
      the reference's whole-screen boxes for quads that straddle the near
      plane, the resident stream dropped 149-698 of them a key past
      HUGE_CAP and changed 20405 pixels of one key (the same bench).

    Returns (launches {part: (K1, K2, K3, K4)}, {part: seconds})."""
    from differential_projection_voxel_renderer_tpu_torch.app import (
        flythrough,
    )
    from differential_projection_voxel_renderer_tpu_torch.app.engine import (
        RenderConfig,
    )

    parts = Parts(torch, "18")
    timed, need = parts.run, parts.need
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

    def primed_engine(**kw):
        eng = new_engine(torch, pool_slots=APP_POOL_SLOTS, prime_all=True,
                         **kw)[0]
        eng.render_frame(dt=0.0)
        return eng

    def dropped(frames):
        return [int(f[2][3]) for f in frames]

    packed = timed("packed settle + prime_all", lambda: primed_engine(
        config=RenderConfig(WIDTH, HEIGHT, packed_raster=True)))
    frames = timed("packed flight", lambda: fly_path(
        packed, flythrough.default_path(FLY_KEYS), ev))
    need("packed flight", FLY_KEYS, 0, 0, FLY_KEYS)
    differ = [(i, int(((a[0] != b[0]) | (a[1] != b[1])).sum()))
              for i, (a, b) in enumerate(zip(frames, primed))
              if not same_frame_bits(torch, a, b)]
    if any(dropped(frames)) or differ:
        raise AssertionError(f"[18] the packed flight: bin_overflow "
                             f"{dropped(frames)}, (key, pixels) that differ "
                             f"from phase 14's serial flight {differ}")
    log(f"[18] packed flight over default_path({FLY_KEYS}): bin_overflow 0 "
        f"on every key, every frame equal to phase 14's primed serial "
        f"flight bit for bit (colour and depth); launches "
        f"{parts.launches['packed flight']}; "
        f"{FLY_KEYS / parts.secs['packed flight']:.2f} frames/s by the host "
        f"clock; {card}")
    del packed, frames

    path = flythrough.default_path(LONG_KEYS)
    flights = {}
    for kind in ("serial", "resident"):
        eng = timed(f"{kind} settle + prime_all",
                    lambda kind=kind: primed_engine(
                        resident=kind == "resident"))
        flights[kind] = timed(f"{kind} long flight",
                              lambda eng=eng: fly_path(eng, path, ev))
        need(f"{kind} long flight", LONG_KEYS, LONG_KEYS, 0, 0)
        if kind == "resident" and not eng.resident_stream:
            raise AssertionError("[18] the resident engine fell back")
        del eng
    differ = [(i, int(((a[0] != b[0]) | (a[1] != b[1])).sum()))
              for i, (a, b) in enumerate(zip(flights["resident"],
                                             flights["serial"]))
              if not same_frame_bits(torch, a, b)]
    drops = {k: dropped(v) for k, v in flights.items()}
    if any(map(any, drops.values())) or differ:
        raise AssertionError(f"[18] the long flights: bin_overflow {drops}, "
                             f"(key, pixels) where the resident frame "
                             f"differs from the serial one {differ}")
    more = [int(a[2][1]) - int(b[2][1])
            for a, b in zip(flights["resident"], flights["serial"])]
    log(f"[18] serial and resident flights over default_path({LONG_KEYS}): "
        f"bin_overflow 0 on every key of both, every resident frame equal "
        f"to the serial frame of its key bit for bit (colour and depth); the "
        f"superset rasterizes {min(more)}..{max(more)} more quads a frame; "
        f"launches serial {parts.launches['serial long flight']}, resident "
        f"{parts.launches['resident long flight']}; {card}")
    return parts.launches, parts.secs


# ---------------------------------------------- span, device meshing, legacy


def static_and_moving(eng):
    """Phase 3's camera sequence on ``eng``: 3 static frames at the start
    pose, then the N_MOVING moving poses; each frame's (colour, depth,
    stats) as device copies, and the static draw list's (uploads, camera
    on the device)."""
    import numpy as np

    eng.camera.position = np.array(START_POS, np.float32)
    eng.camera.look_at(np.array(START_TARGET, np.float32))
    frames = [keep(eng.render_frame(dt=0.0)) for _ in range(3)]
    static = (eng._upload_cache[1], eng.renderer._cam_dev(
        eng.camera.view_projection_matrix(), eng.camera.position))
    for pos, target in moving_poses():
        eng.camera.position = pos
        eng.camera.look_at(target)
        frames.append(keep(eng.render_frame(dt=0.0)))
    return frames, static


def span_path(torch, card):
    """Phase 16 (a): span mode at the headline scene.  An
    Engine(RenderConfig(span_mode=True)) settled and primed drives phase
    3's camera sequence with the plain versions of K1 and K2 made to raise
    (K1's span instance and K2 once a frame, K3 and K4 never); K1's span
    instance and K2 on the span records against their plain versions bit
    for bit on the static stream; the two-pass, temporal and tp = 2 band
    span frames against the serial span frame; the span frame of the
    128x128 fuzz scene against oracle.render_span; K1-span's time and
    bound.  Returns a dict for the kernels line."""
    import numpy as np

    from differential_projection_voxel_renderer_tpu_torch.app.engine import (
        RenderConfig,
    )
    from differential_projection_voxel_renderer_tpu_torch.benches import (
        common,
    )
    from differential_projection_voxel_renderer_tpu_torch.ops import (
        geometry,
        hiz,
        raster,
    )
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        oracle,
        parity,
        pipeline,
    )

    parts = Parts(torch, "16")
    eng, t_world, t_prime = parts.run("span settle + prime", lambda: new_engine(
        torch, RenderConfig(WIDTH, HEIGHT, span_mode=True)))

    def stop(name):
        def plain(*a, **k):
            raise AssertionError(f"[16] the span path ran {name}")
        return plain

    saved = geometry.project_cull_plain, raster.rasterize_tiles_plain
    geometry.project_cull_plain = stop("project_cull_plain")
    raster.rasterize_tiles_plain = stop("rasterize_tiles_plain")
    try:
        frames, (uploads, cam_f) = parts.run(
            "span frames", lambda: static_and_moving(eng))
        span_launches = geometry.launches_span
    finally:
        geometry.project_cull_plain, raster.rasterize_tiles_plain = saved
    n_frames = 3 + N_MOVING
    parts.need("span frames", n_frames, n_frames, 0)
    if span_launches != n_frames or parts.launches["span frames"][3]:
        raise AssertionError(f"[16] span frames: K1-span {span_launches}, "
                             f"launches {parts.launches['span frames']}")
    for f in frames[1:3]:
        if not all(torch.equal(a, b) for a, b in zip(f, frames[0])):
            raise AssertionError("[16] the static span frames differ")
    stats = [f[2].tolist() for f in frames]
    if any(st[2] or st[3] or st[4] for st in stats):
        raise AssertionError(f"[16] span stats {stats}")
    n_px = [nonsky(f[0]) for f in frames]
    if not all(WIDTH * HEIGHT // 4 < n < WIDTH * HEIGHT for n in n_px):
        raise AssertionError(f"[16] implausible span non-sky counts {n_px}")
    log(f"[16] span engine: world {t_world:.2f} s, prime {t_prime:.2f} s; "
        f"{n_frames} frames (3 static, {N_MOVING} moving) launch K1's span "
        f"instance {span_launches} times and K2 "
        f"{parts.launches['span frames'][1]}, K3 and K4 never, the plain "
        f"versions never; static stats {stats[0]} non-sky {n_px[0]}, last "
        f"moving stats {stats[-1]}")

    # K1-span and K2 on the span records against their plain versions
    quads, qw, total = uploads
    vp, cp = pipeline._unpack_cam(cam_f)
    args = (quads, qw, total, vp, cp)
    kw = dict(width=WIDTH, height=HEIGHT, span_mode=True)
    n_valid, _, k1_err = k1_compare(torch, geometry, args, kw)
    got = geometry.project_cull(*args, **kw)
    ref = geometry.project_cull_plain(*args, **kw)
    if not torch.equal(got["ndc"].view(torch.int32),
                       ref["ndc"].view(torch.int32)):
        raise AssertionError("[16] K1-span's NDC box differs from its twin")
    cap = int(quads.shape[0])
    step_kw = eng.renderer._bucket_kw(cap)
    step_kw.pop("near_quads")
    rec = pipeline.render_step(*args, debug_return_records=True, **step_kw)
    verdict, k2_err, nmis, _ = k2_compare(torch, raster, parity, rec,
                                          HEIGHT, WIDTH)
    if verdict != "exact":
        raise AssertionError(f"[16] K2 on span records: {verdict}")
    log(f"[16] K1-span on the span static stream ({cap} bucket, "
        f"{int(total)} quads, {n_valid} valid): five outputs, both counts "
        f"and the NDC box bit-exact against its plain version; K2 on its "
        f"{int(rec[2].sum())} span records: {verdict} against its plain "
        f"version")

    # the occlusion modes and the bands against the serial span frame
    serial = pipeline.render_step(*args, **step_kw)
    if not all(torch.equal(a, b) for a, b in zip(serial, frames[0])):
        raise AssertionError("[16] the span step differs from the engine's "
                             "static frame")

    def same(out):
        return (torch.equal(out[0], serial[0])
                and torch.equal(out[1].view(torch.int32),
                                serial[1].view(torch.int32))
                and int(out[2][1]) + int(out[2][5]) == int(serial[2][1]))

    two = parts.run("span two-pass", lambda: pipeline._two_pass_step(
        *args, near_quads=NEAR_QUADS, **step_kw))
    parts.need("span two-pass", 2, 2, 0)
    temporal = parts.run("span temporal", lambda: pipeline.render_step(
        *args, hiz_level1=hiz.build_max_pyramid(serial[1]), **step_kw))
    parts.need("span temporal", 1, 1, 0)
    band_h = HEIGHT // 2
    bands = parts.run("span bands", lambda: [pipeline.render_step(
        *args, band_y0=y0, band_h=band_h, **step_kw)
        for y0 in (0, band_h)])
    parts.need("span bands", 2, 2, 0)
    stacked = (torch.cat([b[0] for b in bands]),
               torch.cat([b[1] for b in bands]), serial[2])
    for label, out in (("two-pass", two), ("temporal", temporal),
                       ("tp = 2 bands", stacked)):
        if not same(out):
            raise AssertionError(f"[16] the {label} span frame differs from "
                                 f"the serial span frame")
    log(f"[16] span two-pass (near {NEAR_QUADS}; hiz_culled "
        f"{int(two[2][5])}), temporal on the frame's own pyramid "
        f"(hiz_culled {int(temporal[2][5])}) and tp = 2 bands ({band_h} "
        f"rows): each equal to the serial span frame bit for bit")

    # against the float64 span walker on the fuzz scene
    gargs, gkw = parity.small_scene("fuzz 128x128", "cuda")
    w, h = gkw["width"], gkw["height"]
    c, d, _ = pipeline.render_step(*gargs, span_mode=True, **gkw)
    c = c.cpu().numpy().view(np.uint32)
    d = d.cpu().numpy()
    stream = gargs[0].cpu().numpy().view(np.uint32)[:int(gargs[2])]
    oc, od = oracle.render_span(stream, np.zeros(3), gargs[3].cpu().numpy(),
                                gargs[4].cpu().numpy(), w, h)
    o_mis = int((oc != c).sum())
    both = np.isfinite(od) & np.isfinite(d)
    o_err = float(np.abs(od[both] - d[both]).max())
    if o_mis > w * h * 0.001 or o_err >= 1e-4:
        raise AssertionError(f"[16] span frame vs oracle: {o_mis} px, depth "
                             f"{o_err}")
    log(f"[16] span frame of the fuzz scene ({w}x{h}) against "
        f"oracle.render_span: {o_mis} pixels differ (bound "
        f"{w * h * 0.001:.1f}), depth within {o_err:.3g} (bound 1e-4)")

    # K1-span's time and bound on the static stream
    def k1s():
        return geometry.project_cull(*args, **kw)

    out = dict(launches=span_launches, max_abs_err=k1_err,
               call_ms=median_ms(k1s), ms=median_ms(k1s, batch=20),
               graph_ms=common.graph_ms(k1s),
               exact_graph_ms=common.graph_ms(lambda: geometry.project_cull(
                   *args, width=WIDTH, height=HEIGHT)),
               plain_ms=median_ms(lambda: geometry.project_cull_plain(
                   *args, **kw), reps=5), bucket=cap,
               k2_max_abs_err=k2_err, k2_launches=parts.launches[
                   "span frames"][1])
    out["bound_ms"], out["bound_by"] = bound(*k1_work(args, k1s()))
    log(f"[16] K1-span ({cap} quads): {out['call_ms']:.4f} ms a call, "
        f"{out['ms']:.4f} in runs of 20, {out['graph_ms']:.4f} from a CUDA "
        f"graph (K1's exact instance on the same stream "
        f"{out['exact_graph_ms']:.4f}); plain version "
        f"{out['plain_ms']:.4f} ms; bound {out['bound_ms']:.5f} ms "
        f"({out['bound_by']}); {card}")
    return out


def meshing_path(torch, serial, card):
    """Phase 16 (b): device meshing at the headline configuration.  Two
    engines settled and primed with prime_all, one meshing on the host and
    one with device_meshing=True (the settle batch meshed on the card; the
    seconds of each are printed); their pools hold the same chunks with the
    same rows, counts, counts6 and counts6_dev; both drive phase 3's
    camera sequence, and every frame of the device-meshed engine must
    equal the host-meshed engine's bit for bit (colour, depth, stats) and
    phase 3's (colour, depth, stats[:2]).  Returns the seconds."""
    parts = Parts(torch, "16")
    host, hw, hp = parts.run("host settle + prime_all", lambda: new_engine(
        torch, prime_all=True, pool_slots=APP_POOL_SLOTS))
    dev, dw, dp = parts.run("device settle + prime_all", lambda: new_engine(
        torch, prime_all=True, pool_slots=APP_POOL_SLOTS,
        device_meshing=True))
    shared, equal = shared_chunks_equal(torch, host.pool, dev.pool)
    if set(host.pool.by_pos) != set(dev.pool.by_pos) or equal != shared:
        raise AssertionError(f"[16] device-meshed pool: {equal} of {shared} "
                             f"chunks equal the host-meshed pool's")
    log(f"[16] prime_all of the settled world ({len(dev.pool.by_pos)} "
        f"chunks): host mesher {hp:.3f} s, device meshing {dp:.3f} s (worlds "
        f"settled in {hw:.2f} / {dw:.2f} s); the pools hold the same "
        f"chunks with equal rows, counts, counts6 and counts6_dev; "
        f"overflow_drops host {host.pool.overflow_drops}, device "
        f"{dev.pool.overflow_drops}; {card}")
    batches = []
    real = dev._remesh_device

    def spy(to_mesh):
        batches.append(len(to_mesh))
        return real(to_mesh)

    dev._remesh_device = spy
    fh, _ = parts.run("host frames", lambda: static_and_moving(host))
    fd, _ = parts.run("device frames", lambda: static_and_moving(dev))
    refs = [serial["static"]] * 3 + serial["moving"]
    for i, (a, b, r) in enumerate(zip(fd, fh, refs)):
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"[16] device-meshed frame {i} differs from "
                                 f"the host-meshed engine's")
        if not (torch.equal(a[0], r[0]) and torch.equal(
                a[1].view(torch.int32), r[1].view(torch.int32))
                and torch.equal(a[2][:2], r[2][:2])):
            raise AssertionError(f"[16] device-meshed frame {i} differs from "
                                 f"phase 3's")
    parts.need("device frames", len(fd), len(fd), 0)
    log(f"[16] device meshing: {len(fd)} frames at phase 3's poses equal the "
        f"host-meshed engine's (colour, depth, stats) and phase 3's bit for "
        f"bit; device remesh batches during them {batches}; overflow_drops "
        f"{dev.pool.overflow_drops}")
    return dict(host_s=hp, device_s=dp, chunks=len(dev.pool.by_pos),
                overflow=dev.pool.overflow_drops, batches=batches)


def legacy_path(torch, card):
    """Phase 16 (c): the legacy vertex renderer.  One terrain chunk's quads
    become packed vertices (quad_corners_local, pack_vertices) and
    two-triangle fans; render_vertex_mesh draws them on the card at
    1280x720 (seconds, non-sky pixels) and at 320x180, where the card's
    frame must equal the same call's on the CPU bit for bit."""
    import numpy as np

    from differential_projection_voxel_renderer_tpu_torch.meshing.greedy import (
        mesh_chunk,
    )
    from differential_projection_voxel_renderer_tpu_torch.meshing.quad_format import (
        quad_corners_local,
        unpack_quads,
    )
    from differential_projection_voxel_renderer_tpu_torch.models import (
        vertex,
    )
    from differential_projection_voxel_renderer_tpu_torch.models.camera import (
        Camera,
    )
    from differential_projection_voxel_renderer_tpu_torch.models.chunk import (
        Chunk,
    )
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        legacy,
    )

    quads = mesh_chunk(Chunk.generate_terrain((0, 0, 0)))
    n = len(quads)
    corners = quad_corners_local(quads).reshape(-1, 3).astype(np.int64)
    f = unpack_quads(quads)
    light = np.random.default_rng(5).random(4 * n, np.float32)
    packed = vertex.pack_vertices(
        corners[:, 0], corners[:, 1], corners[:, 2], np.repeat(f["block"], 4),
        light, np.repeat(f["face"], 4), np.zeros(4 * n))
    idx = legacy.mesh_quads_to_triangles(n)

    def render(device, w, h):
        cam = Camera(np.array([0.0, 25.0, 0.0], np.float32), w / h)
        cam.look_at(np.array([16.0, 12.0, 16.0], np.float32))
        verts = {k: torch.from_numpy(a).to(device)
                 for k, a in vertex.unpack_vertices(packed).items()}
        return legacy.render_vertex_mesh(
            verts, torch.from_numpy(idx).to(device), len(idx),
            torch.zeros(3, device=device),
            torch.from_numpy(cam.view_projection_matrix().copy()).to(device),
            width=w, height=h)

    render("cuda", WIDTH, HEIGHT)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c, _ = render("cuda", WIDTH, HEIGHT)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    px = int((c != legacy.SKY_I32).sum())
    if px < WIDTH * HEIGHT // 20:
        raise AssertionError(f"[16] the legacy frame shows {px} pixels")
    gc, gd = render("cuda", 320, 180)
    cc, cd = render("cpu", 320, 180)
    if not (torch.equal(gc.cpu(), cc) and torch.equal(
            gd.cpu().view(torch.int32), cd.view(torch.int32))):
        raise AssertionError("[16] the legacy 320x180 frame differs card vs "
                             "CPU")
    log(f"[16] legacy: a terrain chunk's {n} quads as {4 * n} vertices and "
        f"{len(idx)} triangles; render_vertex_mesh at {WIDTH}x{HEIGHT} on "
        f"the card {secs:.3f} s ({px} non-sky pixels); at 320x180 the card's "
        f"frame equals the CPU's bit for bit "
        f"({int((cc != legacy.SKY_I32).sum())} non-sky); {card}")
    return dict(seconds=secs, nonsky=px, triangles=len(idx))


# ------------------------------------------------------------- benches


# phase 17: each bench module of the port's benches/ at its smallest
# setting -- (module, arguments, extra environment, how its output is read:
# a list of (stream, pattern, least count) that must all match)
NUM = r"-?[0-9.]+(?:e-?[0-9]+)?"
BENCH_RUNS = (
    ("bench", ["--quick", "--warmup", "2", "--frames", "5"],
     {"DPVR_SKIP_FULL_PARITY": "1"},
     [("out", r'^\{"metric": "fps_1280x720_vd4_textured_shaded", .*'
              r'"conservative_fps": ' + NUM + r'\}$', 1),
      ("err", r"^device per-frame \(one CUDA graph x30\): " + NUM + " ms$",
       1),
      ("err", r"^PARITY: kernels vs plain twins on .*: fuzz@128x128: exact",
       1)]),
    ("profile_stages", ["project", "compact", "coeffs", "bin", "raster",
                        "raster0", "full", "pbin", "pbin1", "pbin2",
                        "praster"], {"PROF_K": "2"},
     [("out", r'^\{"stage": "[a-z0-9]+", "ms": ' + NUM + r'\}$', 11)]),
    ("micro_project", [], {"PROF_K": "2"},
     [("err", r"^ *(decode|basis|ws|invs|ndc|project): " + NUM + " ms$",
       6)]),
    ("micro_hiz", ["--k", "2"], {},
     [("out", r'^\{"case": "[a-z_]+", "ms": ' + NUM + r'\}$', 3)]),
    ("micro_sort", ["--k", "2"], {},
     [("out", r'^\{"case": "[a-z0-9_]+", "ms": ' + NUM + r'\}$', 8),
      ("err", r"^merge correctness OK at n=", 2)]),
    ("pipeline_experiment", ["base", "pipe", "pipedep", "fused"],
     {"PROF_K": "3"},
     [("out", r'^\{"stage": "(base|pipe|pipedep|fused)", "ms": ' + NUM
       + r'\}$', 4)]),
    ("fly_profile", ["--vd", "4", "--frames", "3"], {},
     [("out", r'^\{"section": "(world_update|remesh_mesh_upload|'
              r'funnel_plus_render|wall_total|chunks_meshed_per_frame)", '
              r'"ms_per_frame": ' + NUM + r'\}$', 5)]),
    ("flythrough_diag", ["4", "--frames", "3"], {},
     [("out", r"^pass [01]: " + NUM + r" FPS \(" + NUM + r" ms/frame\)$",
       2),
      ("out", r"^  _funnel: [0-9]+x, " + NUM + r" ms/frame", 2)]),
    ("run_benches", ["--device", "--quick"], {},
     [("out", r"^== (meshing|world|microbench|rendering|device)", 5),
      ("out", r"^terrain chunk: " + NUM + " ms", 1),
      ("out", r"^single solid chunk frame 256x256: " + NUM
       + " ms/frame in one CUDA graph", 1),
      ("out", r"^project\+cull 131k quads: " + NUM + " ms", 1)]),
    ("kernel_cost_sim", ["--pose", "start"], {},
     [("out", r'^\{"pose": "start", "tiles_nonempty": [0-9]+, .*\}$', 1)]),
)


def run_bench_module(name, argv, env, checks):
    """Run benches.<name>.main(argv) in this process with ``env`` set, its
    standard output and error captured: (seconds, stdout lines, stderr
    lines).  Raises unless it returns 0 and every (stream, pattern, least
    count) of ``checks`` matches that many lines."""
    import contextlib
    import importlib
    import io
    import re

    mod = importlib.import_module(f"{PKG}.benches.{name}")
    out, err = io.StringIO(), io.StringIO()
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = mod.main(list(argv))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    secs = time.perf_counter() - t0
    lines = dict(out=out.getvalue().splitlines(),
                 err=err.getvalue().splitlines())
    if rc != 0:
        raise AssertionError(f"benches.{name} returned {rc}")
    for stream, pattern, least in checks:
        n = sum(1 for ln in lines[stream] if re.match(pattern, ln))
        if n < least:
            raise AssertionError(
                f"benches.{name}: {n} of {least} lines match {pattern!r} on "
                f"std{stream}; its output ends: {lines['out'][-5:]} "
                f"{lines['err'][-5:]}")
    return secs, lines["out"], lines["err"]


def bench_path(torch, eng, static, busy7, k2_counts9, card):
    """Phase 17: the port's measuring side.

    - make_repeated_step(renderer, 4) on phase 3's static stream over 4
      cameras (phase 3's static pose and its first three moving poses):
      the first call runs one eager step and captures 4 (K1 and K2 launch
      5 times by their wrappers, K3 and K4 never); its last frame equals
      an eager render_step on the 4th camera bit for bit (colour, depth,
      stats); a second call replays the graph and launches through no
      wrapper; the device ms a frame of a 30-step graph over 30 jittered
      cameras (the median of 10 replays), beside phase 7's device busy.
    - every bench module of benches/ at its smallest setting in this
      process (BENCH_RUNS: each must return 0 and print its lines), and
      one pass of flythrough_bench in a fresh process.
    - kernel_cost_sim's counts at the start pose (its own scene,
      benches/scene.py) equal phase 9's item-pixels evaluated, needed and
      longest walk.

    Returns {part: seconds}."""
    import json as json_
    import re

    import numpy as np

    from differential_projection_voxel_renderer_tpu_torch.models.camera import (
        Camera,
    )
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        pipeline,
    )

    secs = {}
    r = eng.renderer
    uploads, vp0, cp0 = static
    cams = [(vp0, cp0)]
    for pos, target in list(moving_poses())[:3]:
        c = Camera(np.asarray(pos, np.float32), WIDTH / HEIGHT)
        c.look_at(np.asarray(target, np.float32))
        cams.append((c.view_projection_matrix(), c.position.copy()))
    vps = torch.from_numpy(np.stack([v for v, _ in cams]).astype(
        np.float32)).cuda()
    cps = torch.from_numpy(np.stack([p for _, p in cams]).astype(
        np.float32)).cuda()
    t0 = time.perf_counter()
    run = pipeline.make_repeated_step(r, 4)
    torch.cuda.synchronize()
    reset_counters()
    out = [t.clone() for t in run(*uploads, vps, cps)]
    torch.cuda.synchronize()
    first = counters()
    kw = {k: v for k, v in r._base_step_kw.items() if k != "near_quads"}
    kw.update(render_cap=r.config.quads_cap, tile_k_cap=r.config.tile_k_cap)
    ref = pipeline.render_step(*uploads, vps[3], cps[3], **kw)
    reset_counters()
    again = run(*uploads, vps, cps)
    torch.cuda.synchronize()
    second = counters()
    if first != (5, 5, 0, 0) or second != (0, 0, 0, 0):
        raise AssertionError(f"make_repeated_step launches: {first} after "
                             f"the first call, {second} after the second")
    for name, got in (("first", out), ("replayed", again)):
        if not (same_frame_bits(torch, got, ref)
                and torch.equal(got[2], ref[2])):
            raise AssertionError(f"the {name} graph frame differs from the "
                                 f"eager render_step's")
    if same_frame_bits(torch, out, pipeline.render_step(
            *uploads, vps[0], cps[0], **kw)):
        raise AssertionError("the 4th and 1st cameras give the same frame")
    log(f"[17] make_repeated_step(4) on phase 3's static stream "
        f"({int(uploads[2])} quads): K1 and K2 launched {first[:2]} by the "
        f"first call (1 eager step, 4 captured), none by the replay; the "
        f"last frame equals an eager render_step on the 4th camera bit for "
        f"bit (stats {ref[2].tolist()}), first call and replay")
    k = 30
    run30 = pipeline.make_repeated_step(r, k)
    rng = np.random.default_rng(0)
    jit = torch.from_numpy(rng.normal(0, 0.01, (k, 3)).astype(
        np.float32)).cuda()
    args30 = (*uploads, vps[:1].repeat(k, 1, 1), cps[:1] + jit)
    run30(*args30)
    times = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run30(*args30)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / k)
    graph_ms = statistics.median(times)
    secs["repeated step"] = time.perf_counter() - t0
    log(f"[17] the step from one CUDA graph of {k} (make_repeated_step, "
        f"{k} jittered cameras at the static pose): {graph_ms:.4f} ms a "
        f"frame (median of 10 replays; spread {min(times):.4f}-"
        f"{max(times):.4f}); phase 7's device busy {busy7:.4f} ms a frame; "
        f"{card}")

    for name, argv, env, checks in BENCH_RUNS:
        s, out_lines, err_lines = run_bench_module(name, argv, env, checks)
        secs[name] = s
        tail = (out_lines or err_lines)[-1:]
        log(f"[17] benches.{name} {' '.join(argv)}: {s:.1f} s, "
            f"{len(out_lines)} + {len(err_lines)} lines; last: {tail}")
        if name == "kernel_cost_sim":
            sim = json_.loads(out_lines[-1])
            got = (sim["evaluated"], sim["needed"], sim["longest_walk"])
            if got != k2_counts9:
                raise AssertionError(f"kernel_cost_sim at the start pose "
                                     f"{got} != phase 9's {k2_counts9}")
            log(f"[17] kernel_cost_sim at the start pose: item-pixels "
                f"evaluated {got[0]}, needed {got[1]}, longest walk "
                f"{got[2]}, equal to phase 9's; {sim['walked']} of "
                f"{sim['items']} items walked, {sim['octets_skipped']} "
                f"octets skipped by the break")
    t0 = time.perf_counter()
    fly = subprocess.run(
        [sys.executable, "-m", f"{PKG}.benches.flythrough_bench", "4",
         "--frames", "5", "--passes", "1"], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    secs["flythrough_bench"] = time.perf_counter() - t0
    lines = [ln for ln in fly.stdout.splitlines()
             if re.match(r"^FLYTHROUGH " + NUM + "$", ln)]
    if fly.returncode or not lines:
        raise AssertionError(f"flythrough_bench failed ({fly.returncode}): "
                             f"{fly.stderr[-1500:]}")
    log(f"[17] benches.flythrough_bench 4 --frames 5 --passes 1, a fresh "
        f"process: {lines[0]} ({secs['flythrough_bench']:.1f} s)")
    return secs


# ------------------------------------------------------------- K1 / K2


def k1_compare(torch, geometry, args, kw):
    """K1 vs its twin on the same inputs: (valid count, subpixel count,
    max |depth_near difference|); raises unless all five outputs and both
    counts are bit-exact."""
    got = geometry.project_cull(*args, **kw)
    ref = geometry.project_cull_plain(*args, **kw)
    for k in ("valid", "bbx", "bby", "subpixel", "subpix_total",
              "valid_count"):
        if got[k].dtype != ref[k].dtype or not torch.equal(got[k], ref[k]):
            raise AssertionError(f"K1 {k} differs from its twin")
    a, b = got["depth_near"], ref["depth_near"]
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a - b).abs()[fin].max()) if bool(fin.any()) else 0.0
    same = (a.view(torch.int32) == b.view(torch.int32)) | (
        torch.isnan(a) & torch.isnan(b))
    if not bool(same.all()):
        raise AssertionError(f"K1 depth_near differs, max abs {err}")
    return int(got["valid_count"]), int(got["subpix_total"]), err


def k2_compare(torch, raster, parity, rec, h, w, rows=None, **extra):
    """K2 vs its twin on the same records (``extra``: init_color,
    init_depth, y0_px), over the ``rows`` rows the step keeps (by default
    ``h``): the buffer is padded to the tile, and its padded rows, which
    the step crops, are not compared (the twin, like the reference's
    kernel, evaluates an item on its octet's rows, which may reach them;
    K2 evaluates it on its own box, clamped to the frame or band, and
    must leave them as they started, SKY/+inf with no init frame):
    (parity verdict, max |depth difference| over finite pixels, colour
    mismatch count, (K2's, the twin's) written padded pixels)."""
    import numpy as np

    rows = rows or h
    kw = dict(height=h, width=w, tile_h=16, tile_w=128,
              out_h=-rows % 16 + rows, **extra)
    c1, d1 = raster.rasterize_tiles(*rec, **kw)
    c2, d2 = raster.rasterize_tiles_plain(*rec, **kw)
    padded = tuple(int(((c[rows:] != raster.SKY_I32)
                        | (d[rows:] != float("inf"))).sum())
                   for c, d in ((c1, d1), (c2, d2)))
    if padded[0] and extra.get("init_color") is None:
        raise AssertionError(f"K2 wrote {padded[0]} pixels of the buffer's "
                             f"padded rows")
    c1, d1, c2, d2 = (x[:rows].cpu().numpy() for x in (c1, d1, c2, d2))
    verdict = parity.frame_parity(c1, d1, c2, d2, rec[0].cpu().numpy())
    fin = np.isfinite(d1) & np.isfinite(d2)
    err = float(np.abs(d1[fin] - d2[fin]).max()) if fin.any() else 0.0
    return verdict, err, int((c1 != c2).sum()), padded


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the float32 operations over the float32 rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(args, out) -> tuple[int, int]:
    """(bytes, operations) of stage A over a stream: every input read once,
    every output written once, K1_OPS_PER_QUAD per stream entry."""
    return nbytes(*args, *out.values()), K1_OPS_PER_QUAD * args[0].shape[0]


def profile_frames(torch, frame_fn, n: int = 10):
    """Device time of ``n`` calls of ``frame_fn`` (a static frame) under
    torch.profiler, after one unprofiled call.

    Returns (busy ms/frame: the union of the intervals of every device
    activity, summed device ms/frame, activities/frame, wall ms/frame of
    the profiled frames between CUDA events, [(ms/frame, name)] of device
    activities largest first, [(host ms/frame, calls/frame, name)] of the
    host's operators by self time, largest first), or None when the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frame_fn()
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev0.record()
        for _ in range(n):
            frame_fn()
        ev1.record()
        ev1.synchronize()
    wall = ev0.elapsed_time(ev1) / n
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    by_name = {}
    for e in dev:
        key = e.name[:70]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    top = sorted(((us / n / 1e3, k) for k, us in by_name.items()),
                 reverse=True)
    host = sorted(((a.self_cpu_time_total / n / 1e3, a.count / n, a.key[:50])
                   for a in prof.key_averages()), reverse=True)
    return busy / n / 1e3, total / n / 1e3, len(spans) / n, wall, top, host


def log_profile(phase: str, what: str, prof, ref_ms: float, card: str):
    if prof is None:
        log(f"[{phase}] device time, {what}: not measured (the profiler saw "
            f"no device activity)")
        return
    busy, total, acts, wall, top, host = prof
    log(f"[{phase}] {what} under torch.profiler (10 frames): device busy "
        f"{busy:.4f} ms/frame (union of {acts:.0f} device activities; "
        f"their sum {total:.4f} ms), wall {wall:.3f} ms/frame profiled; "
        f"idle share {1 - busy / wall:.3f} of the profiled frame, "
        f"{1 - busy / ref_ms:.3f} of the unprofiled {ref_ms:.3f} ms; {card}")
    for ms, name in top[:10]:
        log(f"[{phase}]   {ms:.4f} ms/frame  {name}")
    for ms, calls, name in host[:8]:
        log(f"[{phase}]   host {ms:.4f} ms/frame, {calls:.1f} calls  {name}")


# ------------------------------------------------------------- cost probes


def probe_launches():
    """Launch counts (M1, M2, K1, K2, K3, K4)."""
    from differential_projection_voxel_renderer_tpu_torch.ops import micro

    return (micro.launches_fill, micro.launches_copy, *counters())


def probe_path(torch, card, k1_call):
    """Phase 11: the cost-probe path, as ``benches/probe_call.py`` drives
    it.  Drives every variant once through its module's ``run_variant``
    with the counters zeroed before and read after (each variant must
    launch its kernel as often as it calls it, and K1, K3, K4 never);
    holds every output to the plain versions' bit for bit, micro_fixed's
    and micro_fixed3's levels 1-2 also on random tile counts, and K2's
    empty frame to the constant frame (``probe_call.drive``); then times
    each variant (a call, runs of 20, 30 queued, replayed from a CUDA
    graph, host us a call), its plain version and its library call (in
    runs of 20, from a CUDA graph and by host us), and derives its bound
    and launches x floor + bound (``probe_call.time_rows``, ``derive``);
    then the host's cost of a call against the operand count and the
    binding's beside K1's wrapper (``k1_call``: K1's args and kwargs).
    Returns a dict: ``variants`` {(module, label): times}, ``launches``
    (M1, M2, K1-K4), ``errors`` (the max abs error of each kernel against
    its plain version), ``binding``, ``floor_ms`` and ``summary`` (counts
    a kernel, ``probe_call.summary``)."""
    from differential_projection_voxel_renderer_tpu_torch import _build
    from differential_projection_voxel_renderer_tpu_torch.benches import (
        common,
        probe_call,
    )
    from differential_projection_voxel_renderer_tpu_torch.ops import (
        geometry,
    )

    t0 = time.perf_counter()
    mods = probe_call.modules()
    torch.cuda.synchronize()
    reset_counters()
    outs, (m1_n, m2_n, k2_n) = probe_call.drive(torch, mods)
    launches = probe_launches()
    if launches != (m1_n, m2_n, 0, k2_n, 0, 0):
        raise AssertionError(f"probe launches M1, M2, K1-K4 {launches}, "
                             f"expected {(m1_n, m2_n, 0, k2_n, 0, 0)}")
    log(f"[11] cost-probe path: {len(outs)} variants through "
        f"run_variant; launches M1={launches[0]} M2={launches[1]} "
        f"K2={launches[3]} (K1, K3, K4 none)")
    errs = probe_call.check(torch, mods, outs)
    log(f"[11] every variant equal to its plain version bit for bit where "
        f"the kernel writes (micro_fixed and micro_fixed3 levels 1-2 also "
        f"on random tile counts); K2 on the empty 736x1280 stream gives the "
        f"constant frame (SKY, +inf)")

    rows, floor_ms = probe_call.time_rows(torch, mods, outs)
    probe_call.derive(rows, floor_ms, mods)
    for (name, label), t in rows.items():
        log(f"[11] {name} {label} ({t['kernel']}, {t['site']}): a call "
            f"{t['call_ms']:.4f} ms, runs of 20 {t['run_ms']:.4f}, 30 queued "
            f"{t['queued_ms']:.4f}, CUDA graph {t['graph_ms']:.4f}, host "
            f"{t['host_us']:.1f} us a call; plain {t['plain_ms']:.4f}; "
            f"library in runs {t['library_ms']:.4f}, CUDA graph "
            f"{t['library_graph_ms']:.4f}, host {t['library_host_us']:.1f} "
            f"us; bound {t['bound_ms']:.5f} ms ({t['bytes']} bytes), "
            f"launches x floor + bound {t['floor_bound_ms']:.5f} "
            f"({t['launches']} launches; with {t['torch_launches']} torch "
            f"ops around the calls {t['run_floor_bound_ms']:.5f})")

    # host us a call against operand count, and the binding alone (the C
    # entry points called with prepared pointers), all in turns
    lib = _build.lib()
    args, kw = k1_call
    gq = args[0].shape[0]
    gout = geometry.kernel_outputs(gq, args[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    k1_ptrs = (*geometry.kernel_args(*args), None, gq, kw["width"],
               kw["height"], geometry.BACKFACE | geometry.SUBPIXEL,
               *geometry.output_ptrs(gout), None, stream)
    cin = [torch.zeros((1024, 128), dtype=torch.int32, device="cuda")
           for _ in range(9)]
    xs = torch.zeros(1, dtype=torch.int32, device="cuda")
    m2_ptrs = (*(t.data_ptr() for t in cin[:4]), None, None, None, None,
               *(t.data_ptr() for t in cin[4:]), None, None, None,
               xs.data_ptr(), mods["micro"]._copy_params(
                   1024, 64, 4, tuple((1, i, True) for i in range(5))),
               stream)
    m2mod = mods["micro_fixed2"]
    a_base = m2mod.variant("a_base").layout
    fout = mods["micro"].fill_outputs(a_base, "cuda")
    m1_ptrs = (*(o.data_ptr() for o in fout), xs.data_ptr(), *(None,) * 12,
               a_base.c_params, stream)
    fns = {lab.split("_")[1]: m2mod.prepare(lab, probe_call.PROBE_X)
           for lab in m2mod.SWEEP}
    fns.update({
        "K1 wrapper": lambda: geometry.project_cull(*args, **kw),
        "K1 C entry": lambda: lib.dpvr_project_cull(*k1_ptrs),
        "M2 C entry": lambda: lib.dpvr_blocked_copy(*m2_ptrs),
        "M1 C entry": lambda: lib.dpvr_fill_tiles(*m1_ptrs)})
    per = {k: [] for k in fns}
    for _ in range(PROBE_TURNS):
        for k, fn in fns.items():
            per[k].append(common.host_us(fn, blocks=1))
    host = {k: statistics.median(v) for k, v in per.items()}
    k1_graph = common.graph_ms(fns["K1 wrapper"])
    sweep = {k: host[k] for k in fns if "x" in k and " " not in k}
    ops = [sum(map(int, k.split("x"))) for k in sweep]
    slope, icept = statistics.linear_regression(ops, list(sweep.values()))
    log("[11] host us a call by operands (M2's wrapper, n_in x n_out; "
        f"median of {PROBE_TURNS} blocks of 50, taken in turns): "
        + ", ".join(f"{k} {us:.1f}" for k, us in sweep.items())
        + f"; least squares {icept:.1f} + {slope:.2f} an operand; {card}")
    log(f"[11] host us a call: K1's wrapper {host['K1 wrapper']:.1f}, K1's "
        f"C entry alone (ctypes, the counts' memset and the launch, 17 "
        f"arguments) "
        f"{host['K1 C entry']:.1f}; M2's wrapper at 4x5 {sweep['4x5']:.1f}, "
        f"its C entry alone (19 arguments) {host['M2 C entry']:.1f}; M1's "
        f"wrapper at a_base {rows['micro_fixed2', 'a_base']['host_us']:.1f} "
        f"(timed above), its C entry alone (17 arguments) "
        f"{host['M1 C entry']:.1f}; the "
        f"binding is {host['K1 C entry'] / host['K1 wrapper']:.2f} of K1's "
        f"wrapper call; K1's device time a call (131072 quads, from a CUDA "
        f"graph) {k1_graph * 1e3:.1f} us; {card}")
    binding = dict(k1_host_us=host["K1 wrapper"],
                   k1_bare_us=host["K1 C entry"],
                   m2_bare_us=host["M2 C entry"],
                   m1_bare_us=host["M1 C entry"], sweep_us=sweep,
                   us_per_operand=slope, us_at_zero=icept,
                   k1_graph_ms=k1_graph)
    # the graph launch floor: the device time of one launch that does no
    # work (torch.cuda._sleep(0), the CUDA runtime's spin kernel for no
    # cycles) replayed from a CUDA graph; a probe lies within it when its
    # graph time is at most its launches a call times the floor plus its
    # bound, near it within 1.5 times that
    by_site = {}
    for t in rows.values():
        by_site.setdefault((t["kernel"], t["site"]), []).append(t)
    for (kernel, site), ts in by_site.items():
        log(f"[11] {kernel} {site}: from a CUDA graph "
            f"{min(t['graph_ms'] for t in ts):.4f}.."
            f"{max(t['graph_ms'] for t in ts):.4f} ms a call against "
            f"launches x floor + bound "
            f"{min(t['floor_bound_ms'] for t in ts):.4f}.."
            f"{max(t['floor_bound_ms'] for t in ts):.4f} "
            f"({min(t['launches'] for t in ts)}.."
            f"{max(t['launches'] for t in ts)} launches); of "
            f"{len(ts)} variants {sum(t['within_floor'] for t in ts)} "
            f"within, {sum(t['near'] for t in ts)} within 1.5x, "
            f"{sum(t['run_near'] for t in ts)} within 1.5x with the torch "
            f"ops around the calls; {sum(t['beats_library'] for t in ts)} "
            f"no slower in runs than the library call")
    summary = probe_call.summary(rows, floor_ms)
    for kernel in ("M1", "M2"):
        c = summary[kernel]
        log(f"[11] {kernel}: of {c['variants']} variants {c['within']} "
            f"within launches x floor + bound from a CUDA graph, "
            f"{c['near']} within 1.5x of it, {c['run_near']} within 1.5x "
            f"counting the torch ops around the calls; {c['beats_library']} "
            f"no slower in runs of 20 than the library call; {card}")
    log(f"[11] graph launch floor: {floor_ms:.5f} ms a launch that does no "
        f"work, from a CUDA graph of 30; {card}")
    k2e = rows["micro_fixed3", "3"]
    log(f"[11] K2 on the empty 736x1280 stream: {k2e['call_ms']:.4f} ms a "
        f"call, {k2e['run_ms']:.4f} ms in runs of 20, {k2e['graph_ms']:.4f} "
        f"ms from a CUDA graph, {k2e['host_us']:.1f} us of host a call; "
        f"bound {k2e['bound_ms']:.5f} ms; {time.perf_counter() - t0:.1f} s "
        f"for phase 11; {card}")
    return dict(variants=rows, launches=launches, errors=errs,
                binding=binding, floor_ms=floor_ms, summary=summary)


def main() -> int:
    import torch

    # ---- 1. environment
    log(f"[1] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from differential_projection_voxel_renderer_tpu_torch import _build
        from differential_projection_voxel_renderer_tpu_torch.benches import (
            common,
            k1_call,
        )
        from differential_projection_voxel_renderer_tpu_torch.benches import (
            kernel_cost_sim as kcs,
        )
        from differential_projection_voxel_renderer_tpu_torch.ops import (
            geometry,
            hiz,
            raster,
            raster_packed,
        )
        from differential_projection_voxel_renderer_tpu_torch.rendering import (
            parity,
            pipeline,
        )
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}",
              file=sys.stderr)
        return 1
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    card = smi()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] device {kind} x{torch.cuda.device_count()}; nvidia-smi: {card}")
    log(f"[1] nvcc: {run([_build.nvcc(), '--version']).splitlines()[-1]}")

    # ---- 2. build
    secs, ptxas_log = _build.build(force=True, verbose=True)
    lib = _build.lib()
    log(f"[2] built {_build.LIB_PATH} in {secs:.1f} s")
    fma = _build.ptx_fma_counts()
    log(f"[2] floating-point multiply-adds in the PTX: {fma}")
    if any(fma.values()):
        raise AssertionError("a kernel's PTX contracts multiply-adds")
    ptxas = {}
    for entry, rep in _build.ptxas_report(ptxas_log).items():
        for kernel in ("project_cull_kernel", "raster_kernel",
                       "raster_packed_kernel", "fill_tiles_kernel",
                       "blocked_copy_kernel"):
            if f"{len(kernel)}{kernel}" in entry:
                # K1's instances: one quad a thread (the port's), the two-
                # and four-quad ones of benches/k1_call.py --variants, and
                # span mode's (one quad, kSpanMode true)
                rest = entry.partition(f"{kernel}ILi")[2]
                vec = rest[:1]
                if rest[1:].startswith("ELb1"):
                    ptxas[f"{kernel}<span>"] = rep
                else:
                    ptxas[f"{kernel}<{vec}>" if vec not in ("", "1")
                          else kernel] = rep
    blocks = dict(raster_kernel=lib.dpvr_rasterize_tiles_blocks_per_sm(),
                  raster_packed_kernel=(
                      lib.dpvr_rasterize_packed_blocks_per_sm()))
    ptxas["raster_packed_kernel"]["smem"] = (
        lib.dpvr_rasterize_packed_smem_bytes())
    for kernel, rep in sorted(ptxas.items()):
        log(f"[2] ptxas -v {kernel}: {rep['registers']} registers, "
            f"{rep['spill_stores']} bytes of spill stores and "
            f"{rep['spill_loads']} of spill loads, {rep['smem']} bytes of "
            f"shared memory a block"
            + (f", {blocks[kernel]} resident blocks an SM "
               f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor)"
               if kernel in blocks else ""))
    if len(ptxas) != 8:
        raise AssertionError(f"ptxas reported {sorted(ptxas)}")
    for kernel in ("project_cull_kernel", "project_cull_kernel<2>",
                   "project_cull_kernel<4>", "project_cull_kernel<span>"):
        if ptxas[kernel]["spill_stores"] or ptxas[kernel]["spill_loads"]:
            raise AssertionError(f"{kernel} spills: {ptxas[kernel]}")
    for kernel, n in blocks.items():
        rep = ptxas[kernel]
        if rep["spill_stores"] or rep["spill_loads"] or n < 4:
            raise AssertionError(f"{kernel}: spills or under 4 blocks an SM "
                                 f"({rep}, {n} blocks)")

    # ---- 3. main path
    eng, (uploads, vp0, cp0), launches, frame, serial = main_path(torch)

    # ---- 4. K1 vs twin
    r = eng.renderer
    static_cam = r._cam_dev(vp0, cp0)
    vp, cp = pipeline._unpack_cam(static_cam)
    gkw = dict(width=WIDTH, height=HEIGHT)
    words, fqw = k1_call.fuzz_stream(torch, 131072)
    n120k = torch.tensor(120000, dtype=torch.int32, device="cuda")
    fk1 = (words, fqw, n120k, vp, cp)
    quads, qw, total = uploads
    vd12 = (quads, qw, total, vp, cp)
    odd = 131069
    k1_err = 0.0
    for label, a, kw in (
            ("fuzz 131072 (n 120000)", fk1, gkw),
            (f"vd12 stream ({quads.shape[0]} bucket, {int(total)} quads)",
             vd12, gkw),
            (f"vd12 stream, skip_quads {NEAR_QUADS} (device scalar)", vd12,
             dict(gkw, skip_quads=torch.tensor(
                 NEAR_QUADS, dtype=torch.int32, device="cuda"))),
            ("vd12 stream, subpixel_culling=False", vd12,
             dict(gkw, subpixel_culling=False)),
            (f"fuzz {odd}, not a multiple of 4 (n 120000)",
             (words[:odd], fqw[:, :odd].contiguous(), n120k, vp, cp), gkw)):
        n_valid, n_sub, err = k1_compare(torch, geometry, a, kw)
        k1_err = max(k1_err, err)
        log(f"[4] K1 {label}: all five outputs and both counts bit-exact "
            f"against its twin; {n_valid} valid, {n_sub} sub-pixel")

    # ---- 5. K2 vs twin, and the card vs the CPU on a small input
    k2_err = 0.0
    for name in parity.SMALL_SCENES:
        gargs, gkw2 = parity.small_scene(name, "cuda")
        cargs, ckw = parity.small_scene(name, "cpu")
        rec = pipeline.render_step(*gargs, debug_return_records=True, **gkw2)
        verdict, err, nmis, _ = k2_compare(torch, raster, parity, rec,
                                        gkw2["height"], gkw2["width"])
        k2_err = max(k2_err, err)
        log(f"[5] K2 {name}: {verdict} ({nmis} colour mismatches)")
        c_gpu, d_gpu, s_gpu = pipeline.render_step(*gargs, **gkw2)
        c_cpu, d_cpu, s_cpu = pipeline.render_step(*cargs, **ckw)
        rec_cpu = pipeline.render_step(*cargs, debug_return_records=True,
                                       **ckw)
        v = parity.frame_parity(c_gpu.cpu().numpy(), d_gpu.cpu().numpy(),
                                c_cpu.numpy(), d_cpu.numpy(),
                                rec_cpu[0].numpy())
        if not torch.equal(s_gpu.cpu(), s_cpu):
            raise AssertionError(f"{name}: stats differ card vs CPU")
        log(f"[5] {name} frame, card vs CPU twins: {v}; stats "
            f"{s_cpu.tolist()} non-sky {nonsky(c_cpu)}")
    step_kw = r._bucket_kw(int(quads.shape[0]))
    rec720 = pipeline._step_camf(quads, qw, total, static_cam,
                                 debug_return_records=True, **step_kw)
    verdict, err, nmis, _ = k2_compare(torch, raster, parity, rec720, HEIGHT,
                                    WIDTH)
    k2_err = max(k2_err, err)
    counts = rec720[2]
    log(f"[5] K2 1280x720 vd12: {verdict} ({nmis} colour mismatches); "
        f"{int(counts.sum())} items, max {int(counts.max())} per tile")

    # ---- 6. kernel and twin times at the vd12 shapes
    k1_t = {}
    for label, a in (("131072", fk1), ("vd12", vd12)):
        def fn(a=a):
            return geometry.project_cull(*a, **gkw)
        k1_t[label] = dict(call_ms=median_ms(fn),
                           run_ms=median_ms(fn, batch=20),
                           graph_ms=common.graph_ms(fn))
        k1_t[label]["bound_ms"], k1_t[label]["bound_by"] = bound(
            *k1_work(a, fn()))
        t = k1_t[label]
        log(f"[6] K1 {label} ({a[0].shape[0]} quads): {t['call_ms']:.4f} "
            f"ms a call, {t['run_ms']:.4f} in runs of 20, "
            f"{t['graph_ms']:.4f} from a CUDA graph (medians of 20, 20 and "
            f"10 replays of 30); bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']}); {card}")
    k1_ms = k1_t["131072"]["call_ms"]
    k1_plain = median_ms(lambda: geometry.project_cull_plain(*fk1, **gkw))
    rkw = dict(height=HEIGHT, width=WIDTH, tile_h=16, tile_w=128,
               out_h=HEIGHT)
    k2_ms = median_ms(lambda: raster.rasterize_tiles(*rec720, **rkw))
    k2_plain = median_ms(lambda: raster.rasterize_tiles_plain(*rec720, **rkw))
    k1_run = k1_t["131072"]["run_ms"]
    k2_run = median_ms(lambda: raster.rasterize_tiles(*rec720, **rkw),
                       batch=20)
    log(f"[6] K1 131072 quads: kernel {k1_ms:.4f} ms, twin {k1_plain:.4f} ms"
        f" (median of 20; {card})")
    log(f"[6] K2 1280x720 vd12 records: kernel {k2_ms:.4f} ms, twin "
        f"{k2_plain:.4f} ms (median of 20; {card})")
    log(f"[6] in runs of 20 back-to-back calls: K1 {k1_run:.4f} ms, K2 "
        f"{k2_run:.4f} ms per call (median of 20 runs; {card})")
    log(f"[6] static frame {frame['static_ms']:.3f} ms (CUDA events), "
        f"{frame['host_ms']:.3f} ms host clock; {card}")

    # ---- 7. where a static frame's device time goes
    prof7 = profile_frames(torch, lambda: eng.render_frame(dt=0.0))
    log_profile("7", "static frame", prof7, frame["static_ms"], card)

    # ---- 8. frames in flight
    launches8, times8, profiles8 = pipelined_path(torch, serial)
    for mode, runs in times8.items():
        log(f"[8] static frame, {mode}, blocks of {N_TIMED_PIPELINED}: "
            + ", ".join(f"{ev:.3f} ms (CUDA events) / {host:.3f} ms (host)"
                        for ev, host in runs) + f"; {card}")
    log(f"[8] static frame, phase 3 serial (mean of {N_TIMED}): "
        f"{frame['static_ms']:.3f} / {frame['host_ms']:.3f} ms; {card}")
    for mode, prof in profiles8.items():
        ref_ms = statistics.mean(ev for ev, _ in times8[mode])
        log_profile("8", f"{mode} static frame", prof, ref_ms, card)

    # ---- 9. K3 vs K2 + K1
    c2, d2 = raster.rasterize_tiles(*rec720, **rkw)
    cp2, dp2 = raster.rasterize_tiles_plain(*rec720, **rkw)
    if not (torch.equal(c2, cp2) and torch.equal(d2, dp2)):
        raise AssertionError("K2 differs from its plain version at vd12")
    k3_err = 0.0
    for label, nxt in (("fuzzed 131072-quad", fk1), ("vd12", vd12)):
        c3, d3, g3 = raster.rasterize_tiles(*rec720, next_geom=nxt, **rkw)
        if not (torch.equal(c3, c2) and torch.equal(d3, d2)):
            raise AssertionError(f"K3's frame differs from K2's ({label})")
        for ref in (geometry.project_cull(*nxt, **gkw),
                    geometry.project_cull_plain(*nxt, **gkw)):
            for k in ("valid", "bbx", "bby", "subpixel", "subpix_total",
                      "valid_count"):
                if not torch.equal(g3[k], ref[k]):
                    raise AssertionError(f"K3 {k} differs from K1 ({label})")
            a, b = g3["depth_near"], ref["depth_near"]
            if not bool(((a.view(torch.int32) == b.view(torch.int32))
                         | (torch.isnan(a) & torch.isnan(b))).all()):
                raise AssertionError(f"K3 depth_near differs ({label})")
            fin = torch.isfinite(a) & torch.isfinite(b)
            if bool(fin.any()):
                k3_err = max(k3_err, float((a - b).abs()[fin].max()))
        fin = torch.isfinite(d3) & torch.isfinite(d2)
        k3_err = max(k3_err, float((d3 - d2).abs()[fin].max()))
        log(f"[9] K3, {label} next stream: frame equal to K2's and its "
            f"plain version's, geometry equal to K1's and its plain "
            f"version's, bit for bit, counts included "
            f"({int(g3['valid_count'])} valid)")
    def k3():
        return raster.rasterize_tiles(*rec720, next_geom=fk1, **rkw)

    def k2_k1():
        return (raster.rasterize_tiles(*rec720, **rkw),
                geometry.project_cull(*fk1, **gkw))

    k3_ms, k21_ms = median_ms(k3), median_ms(k2_k1)
    k3_run, k21_run = median_ms(k3, batch=20), median_ms(k2_k1, batch=20)
    k3_graph = common.graph_ms(k3)
    k3_host = common.host_us(k3)
    k3_plain = median_ms(lambda: (
        raster.rasterize_tiles_plain(*rec720, **rkw),
        geometry.project_cull_plain(*fk1, **gkw)), reps=5)
    log(f"[9] K3 (vd12 records, 131072-quad next stream): {k3_ms:.4f} ms a "
        f"call, {k3_run:.4f} ms in runs of 20; K2 + K1 launches "
        f"{k21_ms:.4f} ms a call, {k21_run:.4f} ms in runs of 20 (medians "
        f"of 20); plain version {k3_plain:.4f} ms (median of 5); "
        f"{k3_graph:.4f} ms from a CUDA graph; its wrapper {k3_host:.1f} us "
        f"of host a call; {card}")

    # ---- bounds, from this run's inputs
    k1_bytes, k1_ops = k1_work(fk1, geometry.project_cull(*fk1, **gkw))
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    boxes = kcs.item_boxes((quads, qw, total, static_cam), step_kw, rec720)
    k2_bytes, k2_ops, k2_tile_ops, k2_evaluated, k2_needed, k2_walk = (
        kcs.k2_work(rec720, boxes, HEIGHT, WIDTH))
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    k2_tile_ms = k2_tile_ops / (F32_OPS_PER_S / N_SMS) * 1e3
    k3_bound, k3_by = bound(k2_bytes + k1_bytes, k2_ops + k1_ops)
    k3_tile_ms = k2_tile_ms + k1_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[9] bounds: K1 {k1_bound:.5f} ms ({k1_by}: {k1_bytes} bytes, "
        f"{k1_ops} ops); K2 {k2_bound:.5f} ms ({k2_by}: {k2_bytes} bytes, "
        f"{k2_ops} ops), busiest tile {k2_tile_ms:.5f} ms at one SM's share "
        f"({k2_tile_ops} ops); K3 {k3_bound:.5f} ms ({k3_by}), busiest tile "
        f"plus K1's bytes {k3_tile_ms:.5f} ms (H100 SXM data sheet peaks)")
    log(f"[9] K2 on the vd12 records: the kernel evaluates {k2_evaluated} "
        f"item-pixels, the items' boxes in their tiles hold {k2_needed} "
        f"(both over the items the occlusion break leaves); the longest "
        f"tile walk is {k2_walk} items")

    # ---- 10. the packed raster path
    eng10, launches10, frame10, stats10 = packed_path(torch, serial)
    log(f"[10] packed static frame {frame10['static_ms']:.3f} ms (CUDA "
        f"events), {frame10['host_ms']:.3f} ms host clock (mean of "
        f"{N_TIMED_PIPELINED}); phase 3's serial static frame "
        f"{frame['static_ms']:.3f} / {frame['host_ms']:.3f} ms (mean of "
        f"{N_TIMED}); {card}")
    log_profile("10", "packed frame at the last moving pose", profile_frames(
        torch, lambda: eng10.render_frame(dt=0.0)), frame10["static_ms"],
        card)
    k4_err = 0.0

    def depth_err(a, b):
        fin = torch.isfinite(a) & torch.isfinite(b)
        return float((a - b).abs()[fin].max()) if bool(fin.any()) else 0.0

    for name in parity.SMALL_SCENES:
        gargs, gkw2 = parity.small_scene(name, "cuda")
        rec = pipeline.render_step(*gargs, packed_raster=True,
                                   debug_return_records=True, **gkw2)
        pkw = dict(height=gkw2["height"], width=gkw2["width"])
        c4, d4 = raster_packed.rasterize_packed(*rec, **pkw)
        c5, d5 = raster_packed.rasterize_packed_plain(*rec[:5], **pkw)
        if not (torch.equal(c4, c5) and torch.equal(d4, d5)):
            raise AssertionError(f"K4 differs from its plain version "
                                 f"({name})")
        k4_err = max(k4_err, depth_err(d4, d5))
        n_bucket = int(rec[2].view(-1, 5)[:, 1:].sum())
        log(f"[10] K4 {name}: equal to its plain version bit for bit; "
            f"{int(rec[2].sum())} items, {n_bucket} in buckets")
    gargs, gkw2 = parity.small_scene("fuzz 128x128", "cuda")
    cargs, ckw = parity.small_scene("fuzz 128x128", "cpu")
    c_gpu, d_gpu, s_gpu = pipeline.render_step(*gargs, packed_raster=True,
                                               **gkw2)
    c_cpu, d_cpu, s_cpu = pipeline.render_step(*cargs, packed_raster=True,
                                               **ckw)
    rec_cpu = pipeline.render_step(*cargs, packed_raster=True,
                                   debug_return_records=True, **ckw)
    v = parity.frame_parity(c_gpu.cpu().numpy(), d_gpu.cpu().numpy(),
                            c_cpu.numpy(), d_cpu.numpy(), rec_cpu[0].numpy())
    if not torch.equal(s_gpu.cpu(), s_cpu):
        raise AssertionError("packed 128x128: stats differ card vs CPU")
    log(f"[10] packed 128x128 frame, card vs CPU twins: {v}")
    pstep_kw = eng10.renderer._bucket_kw(int(quads.shape[0]))
    recp = pipeline._step_camf(quads, qw, total, static_cam,
                               debug_return_records=True, **pstep_kw)
    pkw = dict(height=HEIGHT, width=WIDTH)
    c4, d4 = raster_packed.rasterize_packed(*recp, **pkw)
    c5, d5 = raster_packed.rasterize_packed_plain(*recp[:5], **pkw)
    if not (torch.equal(c4, c5) and torch.equal(d4, d5)):
        raise AssertionError("K4 differs from its plain version at vd12")
    k4_err = max(k4_err, depth_err(d4, d5))
    if not (torch.equal(c4, c2) and torch.equal(d4, d2)):
        raise AssertionError("K4's vd12 frame differs from K2's")
    pcounts = recp[2].view(-1, 5)
    log(f"[10] K4 1280x720 vd12 packed records: equal to its plain version "
        f"and to K2's frame on the default records, bit for bit; "
        f"{int(pcounts.sum())} items ({int(pcounts[:, 0].sum())} wide, "
        f"{int(pcounts[:, 1:].sum())} in buckets; the default binning "
        f"holds {int(rec720[2].sum())}), at most {int(pcounts.max())} in "
        f"one bin; the static frame's stats {stats10.tolist()}; item cap "
        f"{pstep_kw['tile_k_cap']}")
    k4_ms = median_ms(lambda: raster_packed.rasterize_packed(*recp, **pkw))
    k4_run = median_ms(lambda: raster_packed.rasterize_packed(*recp, **pkw),
                       batch=20)
    k4_graph = common.graph_ms(lambda: raster_packed.rasterize_packed(
        *recp, **pkw))
    k4_host = common.host_us(lambda: raster_packed.rasterize_packed(
        *recp, **pkw))
    k2_run10 = median_ms(lambda: raster.rasterize_tiles(*rec720, **rkw),
                         batch=20)
    k4_plain = median_ms(lambda: raster_packed.rasterize_packed_plain(
        *recp[:5], **pkw), reps=5)
    boxes_p = kcs.item_boxes((quads, qw, total, static_cam), pstep_kw, recp)
    w4 = kcs.k4_work(recp, boxes_p, HEIGHT, WIDTH)
    busiest = w4["tile"]
    k4_bound, k4_by = bound(w4["bytes"], w4["ops"])
    k4_tile_ms = w4["tile_ops"] / (F32_OPS_PER_S / N_SMS) * 1e3
    # where K4's time goes: its launch on the wide bins alone, on the
    # buckets alone, and on the tile with the longest slice walk alone (the
    # other bins' counts set to 0)
    bin_ids = torch.arange(recp[2].numel(), device="cuda")
    wide_bin = bin_ids % 5 == 0
    k4_phase_ms = {}
    for label, keep in (("wide bins only", wide_bin),
                        ("buckets only", ~wide_bin),
                        (f"tile {busiest} only", bin_ids // 5 == busiest)):
        part = (recp[0], recp[1], torch.where(keep, recp[2], 0), *recp[3:])
        k4_phase_ms[label] = median_ms(
            lambda part=part: raster_packed.rasterize_packed(*part, **pkw),
            batch=20)
    log(f"[10] K4 (vd12 packed records): {k4_ms:.4f} ms a call, "
        f"{k4_run:.4f} ms in runs of 20 (medians of 20), {k4_graph:.4f} ms "
        f"from a CUDA graph, its wrapper {k4_host:.1f} us of host a call; K2 "
        f"on the default "
        f"records of the same pose {k2_run10:.4f} ms in runs of 20; plain "
        f"version {k4_plain:.4f} ms (median of 5); K4 on "
        + ", ".join(f"{k} {v:.4f} ms" for k, v in k4_phase_ms.items())
        + f" in runs of 20; {card}")
    log(f"[10] bound: K4 {k4_bound:.5f} ms ({k4_by}: {w4['bytes']} bytes, "
        f"{w4['ops']} ops), busiest tile {k4_tile_ms:.5f} ms at one SM's "
        f"share ({w4['tile_ops']} ops); the occlusion break, in the plain "
        f"version's order, leaves {w4['items']} of {w4['kept']} items; the "
        f"longest walks are {w4['walk_wide']} items in a wide bin (by 256 "
        f"threads) and {w4['walk_bucket']} in a bucket "
        f"({w4['slices_bucket']} slices of 32, each by one warp); the "
        f"longest slice walk is tile {busiest}'s, {w4['slices_tile']} "
        f"bucket slices over its 8 warps (H100 SXM data sheet peaks)")
    log(f"[10] walked bucket items' boxes in their buckets: "
        f"{w4['box_w']:.2f} columns x {w4['box_h']:.2f} rows on average; "
        f"in tile {busiest}: {w4['tile_box_w']:.2f} x "
        f"{w4['tile_box_h']:.2f}")

    # ---- 11. the cost-probe path
    probes = probe_path(torch, card, (fk1, gkw))
    launches11, rows11 = probes["launches"], probes["variants"]
    k2e = rows11["micro_fixed3", "3"]
    k2_graph = common.graph_ms(lambda: raster.rasterize_tiles(*rec720,
                                                              **rkw))
    k2_host = common.host_us(lambda: raster.rasterize_tiles(*rec720, **rkw))
    log(f"[11] K2's floor: on the empty stream {k2e['run_ms']:.4f} ms in "
        f"runs of 20 ({k2e['call_ms']:.4f} a call, {k2e['graph_ms']:.4f} "
        f"from a CUDA graph), at vd12 {k2_run:.4f} ms in runs ({k2_ms:.4f} "
        f"a call, phase 6; {k2_graph:.4f} from a CUDA graph): the empty "
        f"floor is {k2e['run_ms'] / k2_run:.2f} of it in runs, "
        f"{k2e['graph_ms'] / k2_graph:.2f} of its device time; K2's wrapper "
        f"at vd12 {k2_host:.1f} us of host a call; {card}")
    m1, m2 = rows11["micro_fixed2", "a_base"], rows11["micro_fixed2",
                                                      "solo10_4x5"]

    # ---- 12. exact occlusion: two-pass and temporal Hi-Z
    launches12, times12, culled12, profiles12 = occlusion_path(
        torch, eng, serial, card)
    for mode, runs in times12.items():
        log(f"[12] static frame, {mode}, blocks of {N_TIMED_PIPELINED}: "
            + ", ".join(f"{ev:.3f} ms (CUDA events) / {host:.3f} ms (host)"
                        for ev, host in runs) + f"; {card}")
    for mode, prof in profiles12.items():
        log_profile("12", f"{mode} static frame", prof, statistics.mean(
            ev for ev, _ in times12[mode]), card)
    log(f"[12] vd12 hiz_culled: two-pass static frames {culled12['two-pass']}"
        f", temporal static frames {culled12['temporal']} (the first three "
        f"frames, then each timed block's last)")
    init_err, init_t, init_items = k2_init_checks(
        torch, raster, parity, pipeline, hiz, static_cam, uploads, step_kw,
        rec720, (c2, d2), card)
    margins = margin_check(torch, pipeline, hiz, static_cam, uploads,
                           step_kw, (c2, d2))
    log(f"[12] the Hi-Z cull's margin on the vd12 static stream, (quads the "
        f"step culled, pixels that differ from the single pass, quads culled "
        f"at {pipeline.HIZ_MARGIN_ULPS} ulps / strictly as the reference, "
        f"quads on which the two differ): "
        + ", ".join(f"{mode} {v}" for mode, v in margins.items()))
    for mode, (culled, px, at_margin, _, _) in margins.items():
        if px or culled != at_margin:
            raise AssertionError(f"the {mode} Hi-Z cull changed the frame or "
                                 f"culled other quads than its own test")

    # ---- 13. row bands and the camera batch
    launches13, band_ms, band_err = band_path(torch, eng, serial, card)

    # ---- 14. the application surface
    launches14, secs14, fps14, stale14, verdict14, flights14 = app_path(
        torch, eng, serial, (uploads, vp0, cp0), card)
    log("[14] seconds: " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in secs14.items()))
    log(f"[14] flythrough frames/s {fps14}; stale (frames that differ, "
        f"chunks meshed late) {stale14}; {card}")

    # ---- 15. the resident superset stream
    launches15, secs15, kern15 = resident_path(
        torch, serial, flights14, card)
    primed14 = flights14["primed"]
    del flights14
    log("[15] seconds: " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in secs15.items()))

    # ---- 16. span mode, device meshing, the legacy vertex renderer
    span16 = span_path(torch, card)
    mesh16 = meshing_path(torch, serial, card)
    del serial
    legacy16 = legacy_path(torch, card)
    log(f"[16] seconds: the settle batch meshed on the card "
        f"{mesh16['device_s']:.3f}, on the host {mesh16['host_s']:.3f} "
        f"({mesh16['chunks']} chunks, overflow_drops "
        f"{mesh16['overflow']}); the legacy {WIDTH}x{HEIGHT} frame "
        f"{legacy16['seconds']:.3f} ({legacy16['triangles']} triangles); "
        f"{card}")

    # ---- 17. the measuring side: the repeated step and the benches
    t17 = time.perf_counter()
    secs17 = bench_path(torch, eng, (uploads, vp0, cp0), prof7[0],
                        (k2_evaluated, k2_needed, k2_walk), card)
    log("[17] seconds: " + ", ".join(f"{k} {v:.1f}"
                                     for k, v in secs17.items())
        + f"; phase 17 {time.perf_counter() - t17:.1f}")

    # ---- 18. the binnings on the flights that dropped visible quads
    launches18, secs18 = binning_path(torch, primed14, card)
    del primed14
    log("[18] seconds: " + ", ".join(f"{k} {v:.3f}"
                                     for k, v in secs18.items()))
    sites = {k: sorted({r["site"] for r in rows11.values()
                        if r["kernel"] == k}) for k in ("M1", "M2")}
    # (variants within launches x floor + bound, variants) of each probe
    within = {k: (sum(r["within_floor"] for r in rows11.values()
                      if r["kernel"] == k),
                  sum(r["kernel"] == k for r in rows11.values()))
              for k in ("M1", "M2")}

    ref_mods = [m for m in sys.modules if m == REF or m.startswith(REF + ".")]
    if "jax" in sys.modules or ref_mods:
        raise AssertionError(f"the run imported jax or the JAX package: "
                             f"{ref_mods[:5]}")

    kernels = [
        dict(name="K1 stage A (project_cull)", route="cuda",
             source=f"{PKG}/csrc/geometry.cu",
             replaces=f"{REF}/ops/geometry_pallas.py:73",
             launches=launches[0], max_abs_err=k1_err, ms=k1_run,
             plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None, call_ms=k1_ms,
             graph_ms=k1_t["131072"]["graph_ms"],
             vd12_bucket=int(quads.shape[0]),
             vd12_call_ms=k1_t["vd12"]["call_ms"],
             vd12_run_ms=k1_t["vd12"]["run_ms"],
             vd12_graph_ms=k1_t["vd12"]["graph_ms"],
             vd12_bound_ms=k1_t["vd12"]["bound_ms"],
             host_us=probes["binding"]["k1_host_us"],
             c_entry_us=probes["binding"]["k1_bare_us"],
             launches_app={k: v[0] for k, v in launches14.items()},
             launches_resident={k: v[0] for k, v in launches15.items()},
             launches_binning={k: v[0] for k, v in launches18.items()},
             resident_stream_quads=kern15["shape"],
             resident_bucket=kern15["bucket"],
             resident_max_abs_err=kern15["k1_err"],
             resident_graph_ms=kern15["k1_graph_ms"],
             resident_plain_ms=kern15["k1_plain_ms"],
             resident_bound_ms=kern15["k1_bound_ms"],
             resident_bound_by=kern15["k1_bound_by"],
             registers=ptxas["project_cull_kernel"]["registers"],
             spill_bytes=ptxas["project_cull_kernel"]["spill_stores"],
             span_launches=span16["launches"],
             span_max_abs_err=span16["max_abs_err"],
             span_bucket=span16["bucket"], span_ms=span16["ms"],
             span_call_ms=span16["call_ms"],
             span_graph_ms=span16["graph_ms"],
             span_exact_graph_ms=span16["exact_graph_ms"],
             span_plain_ms=span16["plain_ms"],
             span_bound_ms=span16["bound_ms"],
             span_bound_by=span16["bound_by"],
             span_registers=ptxas["project_cull_kernel<span>"]["registers"],
             span_spill_bytes=ptxas["project_cull_kernel<span>"][
                 "spill_stores"]),
        dict(name="K2 tile raster (rasterize_tiles)", route="cuda",
             source=f"{PKG}/csrc/raster.cu",
             replaces=f"{REF}/ops/raster.py:1131",
             launches=launches[1], max_abs_err=k2_err, ms=k2_run,
             plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None, tile_bound_ms=k2_tile_ms,
             registers=ptxas["raster_kernel"]["registers"],
             spill_bytes=ptxas["raster_kernel"]["spill_stores"],
             blocks_per_sm=blocks["raster_kernel"],
             graph_ms=k2_graph, empty_ms=k2e["run_ms"],
             empty_graph_ms=k2e["graph_ms"],
             empty_bound_ms=k2e["bound_ms"],
             empty_library_ms=k2e["library_ms"],
             launches_two_pass=launches12["two-pass"][1],
             launches_temporal=launches12["temporal"][1],
             launches_bands={k: v[1] for k, v in launches13.items()},
             init_max_abs_err=init_err, band_max_abs_err=band_err,
             init_ms=init_t["far_init_run_ms"],
             init_call_ms=init_t["far_init_ms"],
             init_graph_ms=init_t["far_init_graph_ms"],
             same_records_no_init_ms=init_t["far_no_init_run_ms"],
             same_records_no_init_graph_ms=init_t["far_no_init_graph_ms"],
             full_records_init_graph_ms=init_t["full_init_graph_ms"],
             full_records_no_init_graph_ms=init_t["full_no_init_graph_ms"],
             init_items=init_items, band_ms=band_ms, host_us=k2_host,
             launches_app={k: v[1] for k, v in launches14.items()},
             production_parity=verdict14,
             launches_resident={k: v[1] for k, v in launches15.items()},
             launches_binning={k: v[1] for k, v in launches18.items()},
             resident_items=kern15["items"],
             resident_tile_k_cap=kern15["tile_k_cap"],
             resident_render_cap=kern15["render_cap"],
             resident_max_abs_err=kern15["k2_err"],
             resident_graph_ms=kern15["k2_graph_ms"],
             resident_plain_ms=kern15["k2_plain_ms"],
             resident_bound_ms=kern15["k2_bound_ms"],
             resident_bound_by=kern15["k2_bound_by"],
             resident_serial_graph_ms=kern15["k2_serial_graph_ms"],
             launches_span=span16["k2_launches"],
             span_max_abs_err=span16["k2_max_abs_err"]),
        dict(name="K3 tile raster + next frame's stage A "
                  "(rasterize_tiles next_geom)", route="cuda",
             source=f"{PKG}/csrc/raster.cu",
             replaces=f"{REF}/ops/raster.py:678",
             launches=launches8[2], max_abs_err=k3_err, ms=k3_run,
             plain_ms=k3_plain, bound_ms=k3_bound, bound_by=k3_by,
             library_ms=None, tile_bound_ms=k3_tile_ms,
             k2_plus_k1_ms=k21_run, graph_ms=k3_graph, host_us=k3_host,
             launches_app={k: v[2] for k, v in launches14.items()},
             launches_resident={k: v[2] for k, v in launches15.items()}),
        dict(name="K4 packed tile raster (rasterize_packed)", route="cuda",
             source=f"{PKG}/csrc/raster_packed.cu",
             replaces=f"{REF}/ops/raster_packed.py:205",
             launches=launches10[3], max_abs_err=k4_err, ms=k4_run,
             plain_ms=k4_plain, bound_ms=k4_bound, bound_by=k4_by,
             library_ms=None, tile_bound_ms=k4_tile_ms,
             k2_same_frame_ms=k2_run10, graph_ms=k4_graph, host_us=k4_host,
             registers=ptxas["raster_packed_kernel"]["registers"],
             spill_bytes=ptxas["raster_packed_kernel"]["spill_stores"],
             blocks_per_sm=blocks["raster_packed_kernel"],
             split_ms=k4_phase_ms,
             launches_resident={k: v[3] for k, v in launches15.items()},
             launches_binning={k: v[3] for k, v in launches18.items()}),
        dict(name="M1 constant tile fill (fill_tiles), at a_base",
             route="cuda", source=f"{PKG}/csrc/micro.cu",
             replaces="benches/micro_fixed2.py:65",
             launches=launches11[0], max_abs_err=probes["errors"]["M1"],
             ms=m1["run_ms"],
             plain_ms=m1["plain_ms"], bound_ms=m1["bound_ms"],
             bound_by=m1["bound_by"], library_ms=m1["library_ms"],
             library_graph_ms=m1["library_graph_ms"],
             library_host_us=m1["library_host_us"],
             call_ms=m1["call_ms"], queued_ms=m1["queued_ms"],
             graph_ms=m1["graph_ms"], host_us=m1["host_us"],
             c_entry_us=probes["binding"]["m1_bare_us"],
             replaces_all=sites["M1"],
             launch_floor_ms=probes["floor_ms"],
             floor_bound_ms=m1["floor_bound_ms"],
             variants_within_floor=within["M1"],
             variant_counts=probes["summary"]["M1"],
             registers=ptxas["fill_tiles_kernel"]["registers"],
             spill_bytes=ptxas["fill_tiles_kernel"]["spill_stores"]),
        dict(name="M2 blocked copy (blocked_copy), at make9 4x5",
             route="cuda", source=f"{PKG}/csrc/micro.cu",
             replaces="benches/micro_fixed2.py:678",
             launches=launches11[1], max_abs_err=probes["errors"]["M2"],
             ms=m2["run_ms"],
             plain_ms=m2["plain_ms"], bound_ms=m2["bound_ms"],
             bound_by=m2["bound_by"], library_ms=m2["library_ms"],
             library_graph_ms=m2["library_graph_ms"],
             library_host_us=m2["library_host_us"],
             call_ms=m2["call_ms"], queued_ms=m2["queued_ms"],
             graph_ms=m2["graph_ms"], host_us=m2["host_us"],
             c_entry_us=probes["binding"]["m2_bare_us"],
             replaces_all=sites["M2"],
             launch_floor_ms=probes["floor_ms"],
             floor_bound_ms=m2["floor_bound_ms"],
             variants_within_floor=within["M2"],
             variant_counts=probes["summary"]["M2"],
             binding_us=probes["binding"],
             registers=ptxas["blocked_copy_kernel"]["registers"],
             spill_bytes=ptxas["blocked_copy_kernel"]["spill_stores"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``csrc/`` (nvcc, sm_90a), drives the
serial frame path of ``Engine.render_frame``, the frames-in-flight path
of ``Engine.render_frame_pipelined`` and the packed raster path at the
headline scene (1280x720, view distance 12, textures and shading on, from
the reference start pose) and the cost-probe path at the probes' 736x1280
frame, holds each kernel against its plain PyTorch version on the card,
and times kernels and frames.  Phases:

1. environment (torch, CUDA, nvcc, the card's name and power limit);
2. kernel build, the count of floating-point multiply-adds in each
   source's PTX (the rounding contract wants none), and ptxas's registers,
   spills and shared memory of each kernel with the resident blocks an SM
   holds of K2/K3 and K4 (no spills and at least 4 blocks, or it fails);
3. the serial path: world streamed until settled, prime(), 3 static frames
   (render_fused, then render_prepared), 50 timed static frames, then 10
   moving frames that stream chunks (render_fused_insert where the remesh
   batch fits its payload, else render_fused).  The kernels' launch
   counters are zeroed before it and read after it; K1 and K2 must grow on
   every frame, and the stats must show no overflow.  The static and
   moving frames are kept for phase 8;
4. K1 (stage A) vs its twin, bit-exact on all five outputs: a fuzzed
   131072-quad stream and the real vd12 stream;
5. K2 (tile raster) vs its twin on the port's own records at 128x128,
   640x128 and 1280x720: full-frame equality, or the boundary-verified
   gate with its mismatch count; and the 128x128 frame on the card vs the
   same step on the CPU (the twins);
6. kernel and twin times at the vd12 shapes, median of 20 runs each;
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
   frame.  Each variant is timed (a call, runs of 20, 30 queued, host us a
   call) beside its plain version, its library call (``Tensor.fill_`` on
   each output for M1 and K2, ``torch.add`` into each output for M2) and
   its bound; then the host us a launch against the operand count, K1's
   wrapper against its C entry point called alone, and K2's empty floor
   beside its vd12 time of phase 6.

The script imports the port package and nothing else of the repo; before
it prints its result it checks that neither jax nor any module of the JAX
package was loaded.  Every number printed comes from this run; each
kernel's bound is computed from this run's inputs (``bound_ms``: the larger
of its bytes over the card's memory rate and its operations over the
card's float32 rate).  Its last three lines are the JSON object with one
entry per kernel (K1-K4, and M1 at ``a_base`` and M2 at ``make9``'s 4x5
form with every probe site each replaces; K2's entry also gives its empty
floor), the card's name and power limit as nvidia-smi gives
them, and ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
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

# NVIDIA H100 SXM data sheet: HBM rate and dense float32 rate outside the
# tensor cores, at the full 700 W power limit.  The float32 rate counts a
# fused multiply-add as two operations; the kernels are built with
# -fmad=false and issue none, so for the operations counted below their
# own issue limit is half that rate (the bounds keep the data sheet's)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
N_SMS = 132
# float32 operations a function needs, counted from the sources: stage A
# per quad (the basis, four projected corners, the NDC divides, min/max,
# the frustum, backface and sub-pixel tests and the bbox); the tile raster
# per pixel of an item's box (four plane evaluations of a multiply and two
# adds, four coverage products, six compares) and per item and column of
# its box (the four hoisted column products)
K1_OPS_PER_QUAD = 200
K2_OPS_PER_PIXEL = 22
K2_OPS_PER_ITEM_COLUMN = 4
# micro_fixed2's scalar x in phase 11 (SKY + x must differ from SKY), and
# the turns of the host-time comparisons
PROBE_X = 7
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
    raster.launches = 0
    raster.launches_geom = 0
    raster_packed.launches = 0
    micro.launches_fill = 0
    micro.launches_copy = 0


# ------------------------------------------------------------- main path


def new_engine(torch, config=None):
    """An Engine on the card at the headline scene (``config``, by default
    RenderConfig(WIDTH, HEIGHT)), its world settled and primed at the start
    pose: (engine, world seconds, prime seconds)."""
    import numpy as np

    from differential_projection_voxel_renderer_tpu_torch.app.engine import (
        Engine,
        RenderConfig,
        WorldConfig,
    )

    t0 = time.perf_counter()
    eng = Engine(config or RenderConfig(WIDTH, HEIGHT),
                 WorldConfig(view_distance=VIEW_DISTANCE))
    eng.camera.position = np.array(START_POS, np.float32)
    eng.camera.look_at(np.array(START_TARGET, np.float32))
    while eng.world.update(eng.camera.position):
        pass
    t1 = time.perf_counter()
    eng.prime()
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
    serial = dict(static=static_frames[0], moving=moving)
    return (eng, static, launches, dict(static_ms=dev_ms, host_ms=host_ms),
            serial)


def same_frame(torch, res, ref):
    """A device bool: ``res`` shows ``ref``'s colour, depth bits and
    stats[:2] (no host sync)."""
    return ((res.color == ref[0]).all()
            & (res.depth.view(torch.int32) == ref[1].view(torch.int32)).all()
            & (res.stats[:2] == ref[2][:2]).all())


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


# ------------------------------------------------------------- K1 / K2


def fuzz_stream(torch, n, seed=0):
    """Random valid quad words over all faces and field ranges, chunk
    origins within the view distance."""
    g = torch.Generator().manual_seed(seed)
    f = [torch.randint(0, hi, (n,), generator=g)
         for hi in (32, 32, 64, 64, 4, 32, 6)]
    u, v, w, h, blk, sl, face = f
    words = (u | (v << 5) | (w << 10) | (h << 16) | (blk << 22)
             | (sl << 24) | (face << 29))
    words = torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)
    qw = (torch.randint(-VIEW_DISTANCE, VIEW_DISTANCE + 1, (3, n),
                        generator=g) * 32).float()
    qw[1] = (torch.randint(-2, 2, (n,), generator=g) * 32).float()
    return words.cuda(), qw.cuda()


def k1_compare(torch, geometry, args, kw):
    """K1 vs its twin on the same inputs: (valid count, max |depth_near
    difference|); raises unless all five outputs are bit-exact."""
    got = geometry.project_cull(*args, **kw)
    ref = geometry.project_cull_plain(*args, **kw)
    for k in ("valid", "bbx", "bby", "subpixel"):
        if not torch.equal(got[k], ref[k]):
            raise AssertionError(f"K1 {k} differs from its twin")
    a, b = got["depth_near"], ref["depth_near"]
    fin = torch.isfinite(a) & torch.isfinite(b)
    err = float((a - b).abs()[fin].max()) if bool(fin.any()) else 0.0
    same = (a.view(torch.int32) == b.view(torch.int32)) | (
        torch.isnan(a) & torch.isnan(b))
    if not bool(same.all()):
        raise AssertionError(f"K1 depth_near differs, max abs {err}")
    return int(got["valid"].sum()), err


def k2_compare(torch, raster, parity, rec, h, w):
    """K2 vs its twin on the same records: (parity verdict, max |depth
    difference| over finite pixels, colour mismatch count)."""
    import numpy as np

    kw = dict(height=h, width=w, tile_h=16, tile_w=128, out_h=-h % 16 + h)
    c1, d1 = raster.rasterize_tiles(*rec, **kw)
    c2, d2 = raster.rasterize_tiles_plain(*rec, **kw)
    c1, d1, c2, d2 = (x.cpu().numpy() for x in (c1, d1, c2, d2))
    verdict = parity.frame_parity(c1, d1, c2, d2, rec[0].cpu().numpy())
    fin = np.isfinite(d1) & np.isfinite(d2)
    err = float(np.abs(d1[fin] - d2[fin]).max()) if fin.any() else 0.0
    return verdict, err, int((c1 != c2).sum())


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


def item_boxes(torch, pipeline, step_args, step_kw, rec):
    """Each binned item's screen bbox (x0, x1, y0, y1), inclusive pixels,
    each i32[cap]: render_step on the same inputs again, with its tile-box
    packer and its binner (the packed path's with ``packed_raster``)
    observed to map items to quads.  Raises unless that call gives
    ``rec``'s blend fields and the items' bby row."""
    seen = {}
    packed = step_kw.get("packed_raster", False)
    mod, attr = ((pipeline.packed_ops, "build_bin_lists") if packed
                 else (pipeline.raster_ops, "build_tile_lists"))
    pack = pipeline.proj_ops.pack_tilebox
    binner = getattr(mod, attr)

    def pack_spy(*a, **kw):
        seen["box"] = a
        return pack(*a, **kw)

    def bin_spy(*a, **kw):
        out = binner(*a, **kw)
        seen["flat"] = out[0].long()
        return out

    pipeline.proj_ops.pack_tilebox = pack_spy
    setattr(mod, attr, bin_spy)
    try:
        # the packed path's "gather" output: (blend fields, words with bby
        # in row 4, ...); the default path keeps bby in record row 20
        again = pipeline._step_camf(
            *step_args, debug_return_records="gather" if packed else True,
            **step_kw)
    finally:
        pipeline.proj_ops.pack_tilebox = pack
        setattr(mod, attr, binner)
    x0, x1, y0, y1 = (b[seen["flat"]] for b in seen["box"])
    same, bby = ((torch.equal(again[0].view(torch.int32), rec[0][:16]),
                  again[1][4]) if packed
                 else (torch.equal(again[0], rec[0]), again[0][20]))
    if not (same and torch.equal(y0 | (y1 << 16), bby)):
        raise AssertionError("the items' boxes do not match the records")
    return x0, x1, y0, y1


def walk_sums(torch, per_item, st, walked):
    """Per segment, the sum of ``per_item`` over its walk [st, walked)."""
    cum = torch.cat([torch.zeros(1, dtype=torch.long, device=per_item.device),
                     torch.cumsum(per_item, 0)])
    return cum[walked] - cum[st]


def box_in_window(torch, boxes, n, cx0, cx1, ty):
    """(columns, rows) of the first ``n`` items' screen boxes inside
    columns [cx0, cx1] and the 16 rows from ``ty``; no columns where no
    rows."""
    x0, x1, y0, y1 = (b[:n].long() for b in boxes)
    cols = torch.clamp(torch.minimum(x1, cx1) - torch.maximum(x0, cx0) + 1,
                       min=0)
    rows = torch.clamp(torch.minimum(y1, ty + 15) - torch.maximum(y0, ty)
                       + 1, min=0)
    return torch.where(rows > 0, cols, 0), rows


def item_rows(torch, bby, row0):
    """Rows of each item's screen box (bby = y0 | y1 << 16) inside the
    16-row tile that starts at ``row0``, as the kernels clamp them."""
    y0 = torch.clamp((bby & 0xFFFF) - row0, 0, 15)
    y1 = torch.clamp((bby >> 16) - row0, 0, 15)
    return (y1 - y0 + 1).long()


def k2_work(torch, raster, rec, boxes, height, width):
    """(bytes, operations, the busiest tile's operations, pixels the
    kernel evaluates, pixels the inputs need, the longest tile walk in
    items) of the tile raster on these records.  A tile's walk ends at the
    first octet base (a multiple of 8) strictly inside its segment where
    the suffix-min of near depth lies beyond every depth the tile holds so
    far (the occlusion break: no later item can win a pixel); the depth at
    each base comes from K2 on the segment prefixes, all tiles at once, the
    m-th base of each tile in the m-th launch.  An item of the walk needs
    the pixels of its screen bbox (``boxes``) inside its tile,
    K2_OPS_PER_PIXEL each, plus K2_OPS_PER_ITEM_COLUMN per column of that
    box.  The kernel evaluates more: every column of its tile for each row
    of its own box."""
    records, starts, counts, orows, ozmin = rec
    out_h = -height % 16 + height
    tiles_y, tiles_x = out_h // 16, width // 128
    kw = dict(height=height, width=width, tile_h=16, tile_w=128, out_h=out_h)
    st, ends = starts.long(), (starts + counts).long()
    if not torch.equal(st, torch.cumsum(counts.long(), 0) - counts.long()):
        raise AssertionError("the tile segments are not contiguous")
    walked = ends.clone()
    first = torch.div(st, 8, rounding_mode="floor")
    for m in range(1, int(counts.max()) // 8 + 2):
        b = (first + m) * 8
        active = b < walked
        if not bool(active.any()):
            break
        pc = torch.where(active, b - st, 0)
        _, depth = raster.rasterize_tiles(records, starts, pc.int(), orows,
                                          ozmin, **kw)
        dmax = depth.view(tiles_y, 16, tiles_x, 128).amax(dim=(1, 3))
        zm = ozmin[torch.clamp(b >> 3, max=ozmin.numel() - 1)]
        walked = torch.where(active & (zm > dmax.reshape(-1)), b, walked)

    def per_tile(per_item):
        return walk_sums(torch, per_item, st, walked)

    n_kept = int(ends[-1])
    tile = torch.repeat_interleave(
        torch.arange(tiles_y * tiles_x, device=counts.device), counts.long())
    ty, tx = tile // tiles_x * 16, tile % tiles_x * 128
    cols, rows = box_in_window(torch, boxes, n_kept, tx, tx + 127, ty)
    ops = per_tile(cols * (rows * K2_OPS_PER_PIXEL + K2_OPS_PER_ITEM_COLUMN))
    evaluated = per_tile(item_rows(torch, records[20, :n_kept], ty) * 128)
    n_items = int((walked - st).sum())
    # an item reads its 21 record words and its octet's suffix-min word;
    # the frame writes colour and depth
    moved = (n_items * (21 * 4) + n_items // 8 * 4 + nbytes(starts, counts)
             + out_h * width * 8)
    return (moved, int(ops.sum()), int(ops.max()), int(evaluated.sum()),
            int(per_tile(cols * rows).sum()), int((walked - st).max()))


def k4_work(torch, raster_packed, rec, boxes, height, width):
    """The work of K4 on these packed records, a dict: bytes, ops
    (operations), tile_ops (the busiest tile's), items (walked), kept,
    walk_wide and walk_bucket (the longest walks), slices_bucket (the most
    32-item slices of one bucket's walk), slices_tile and tile (the most
    bucket slices one tile walks, and that tile), and box_w, box_h and
    tile_box_w, tile_box_h (the mean columns and rows of the walked
    bucket items' boxes in their buckets, over all tiles and in that
    tile).  A bin's walk ends at its occlusion break in the
    serial order of the plain version -- the wide bin, then each bucket --
    which walks the fewest items of any order of K4's slices, since it
    tests each octet against the nearest depths possible: the wide bin at
    octet bases strictly inside it, against the max depth of its tile over
    the wide prefix so far; a bucket at octet bases at or past its start,
    against the max depth of its 512 pixels after the tile's wide walk and
    the bucket's own prefix.  The depths come from K4 on those prefixes,
    all bins at once, the m-th octet base of each in the m-th launch.  An
    item of a walk needs the pixels of its screen bbox (``boxes``) inside
    its bin's columns (the tile's 128, or the bucket's 32) and its tile's
    rows, K2_OPS_PER_PIXEL each, plus K2_OPS_PER_ITEM_COLUMN per column of
    that box."""
    BINS_PER_TILE = raster_packed.BINS_PER_TILE
    records, starts, counts, orows, ozmin, item_bby, item_bbx = rec
    out_h = -height % 16 + height
    tiles_y, tiles_x = out_h // 16, width // 128
    n_tiles = tiles_y * tiles_x
    kw = dict(height=height, width=width, out_h=out_h)
    st, cn = starts.long(), counts.long()
    ends = st + cn
    if not torch.equal(st, torch.cumsum(cn, 0) - cn):
        raise AssertionError("the bin segments are not contiguous")
    kind = torch.arange(st.numel(), device=st.device) % BINS_PER_TILE
    wide = kind == 0
    walked = ends.clone()

    def depth_of(prefix):
        return raster_packed.rasterize_packed(
            records, starts, prefix.int(), orows, ozmin, item_bby, item_bbx,
            **kw)[1]

    first = torch.div(st, 8, rounding_mode="floor")
    for m in range(1, int(cn[wide].max()) // 8 + 2):
        b = (first + m) * 8
        active = wide & (b < walked)
        if not bool(active.any()):
            break
        dmax = depth_of(torch.where(active, b - st, 0)).view(
            tiles_y, 16, tiles_x, 128).amax(dim=(1, 3))
        dmax = dmax.reshape(-1).repeat_interleave(BINS_PER_TILE)
        zm = ozmin[torch.clamp(b >> 3, max=ozmin.numel() - 1)]
        walked = torch.where(active & (zm > dmax), b, walked)
    first = torch.div(st + 7, 8, rounding_mode="floor")
    for m in range(0, int(cn[~wide].max()) // 8 + 2):
        b = (first + m) * 8
        active = ~wide & (b < walked)
        if not bool(active.any()):
            break
        pc = torch.where(wide, walked - st, torch.where(active, b - st, 0))
        dmax = depth_of(pc).view(tiles_y, 16, tiles_x, 4, 32).amax(
            dim=(1, 4)).reshape(n_tiles, 4)
        dmax = torch.cat([dmax[:, :1], dmax], 1).reshape(-1)
        zm = ozmin[torch.clamp(b >> 3, max=ozmin.numel() - 1)]
        walked = torch.where(active & (zm > dmax), b, walked)

    n_kept = int(ends[-1])
    bins = torch.repeat_interleave(torch.arange(st.numel(),
                                                device=st.device), cn)
    tile, k = bins // BINS_PER_TILE, bins % BINS_PER_TILE
    ty = tile // tiles_x * 16
    cx0 = tile % tiles_x * 128 + torch.where(k == 0, 0, 32 * (k - 1))
    cx1 = cx0 + torch.where(k == 0, 127, 31)
    cols, rows = box_in_window(torch, boxes, n_kept, cx0, cx1, ty)
    ops = walk_sums(torch, cols * (rows * K2_OPS_PER_PIXEL
                                   + K2_OPS_PER_ITEM_COLUMN), st, walked)
    n_items = int((walked - st).sum())
    # an item reads its 20 record words, its bby and bbx and its octet's
    # suffix-min word; the frame writes colour and depth
    moved = (n_items * (22 * 4) + n_items // 8 * 4 + nbytes(starts, counts)
             + out_h * width * 8)
    tile_ops = ops.view(n_tiles, BINS_PER_TILE).sum(1)
    walk = walked - st
    # the 32-aligned slices of each bucket's walk
    slices = torch.where(~wide & (walk > 0),
                         torch.div(walked - 1, 32, rounding_mode="floor")
                         - torch.div(st, 32, rounding_mode="floor") + 1, 0)
    tile_slices = slices.view(n_tiles, BINS_PER_TILE).sum(1)
    busiest = int(tile_slices.argmax())
    # the walked bucket items' boxes in their buckets
    pos = torch.arange(n_kept, device=st.device)
    in_walk = (k > 0) & (pos < walked[bins])
    in_tile = in_walk & (tile == busiest)
    return dict(
        bytes=moved, ops=int(ops.sum()), tile_ops=int(tile_ops.max()),
        items=n_items, kept=n_kept, walk_wide=int(walk[wide].max()),
        walk_bucket=int(walk[~wide].max()), slices_bucket=int(slices.max()),
        slices_tile=int(tile_slices.max()), tile=busiest,
        box_w=float(cols[in_walk].float().mean()),
        box_h=float(rows[in_walk].float().mean()),
        tile_box_w=float(cols[in_tile].float().mean()),
        tile_box_h=float(rows[in_tile].float().mean()))


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


def probe_modules() -> dict:
    from differential_projection_voxel_renderer_tpu_torch.benches import (
        micro_fixed,
        micro_fixed2,
        micro_fixed3,
    )

    return dict(micro_fixed=micro_fixed, micro_fixed2=micro_fixed2,
                micro_fixed3=micro_fixed3)


def probe_variants():
    """[(module name, module, label, run arguments)] of the cost-probe
    path: micro_fixed's levels, micro_fixed2's 63 labels and its SOLO10
    sweep (x = PROBE_X), micro_fixed3's levels and h variants."""
    m = probe_modules()
    return ([("micro_fixed", m["micro_fixed"], str(lv), ())
             for lv in m["micro_fixed"].LEVELS]
            + [("micro_fixed2", m["micro_fixed2"], lab, (PROBE_X,))
               for lab in m["micro_fixed2"].LABELS + m["micro_fixed2"].SWEEP]
            + [("micro_fixed3", m["micro_fixed3"], lab, ())
               for lab in m["micro_fixed3"].LABELS])


def probe_launches():
    """Launch counts (M1, M2, K1, K2, K3, K4)."""
    from differential_projection_voxel_renderer_tpu_torch.ops import micro

    return (micro.launches_fill, micro.launches_copy, *counters())


def library_call(torch, v, outs):
    """The PyTorch calls that compute a variant's function on the same
    inputs into its outputs: ``Tensor.fill_`` of each output with its value
    (M1, and K2 on the empty stream, whose frame is constant), or
    ``torch.add`` into each output for each of M2's calls."""
    if v.kernel in ("M1", "K2"):
        vals = [o.reshape(-1)[0].clone() for o in outs]
        return lambda: [o.fill_(c) for o, c in zip(outs, vals)]
    in0 = torch.zeros_like(outs[0])
    adds = [torch.tensor(a + (PROBE_X if ax else 0), dtype=torch.int32,
                         device=in0.device) for _, a, ax in v.pairs]

    def lib():
        for _ in range(v.calls):
            for (m, _, _), o, c in zip(v.pairs, outs, adds):
                torch.add(in0, in0 if m == 2 else c, out=o)
    return lib


def probe_path(torch, card, k1_call):
    """Phase 11: the cost-probe path.  Drives every variant once through
    its module's ``run_variant`` with the counters zeroed before and read
    after (each variant must launch its kernel as often as it calls it);
    holds every output to the plain versions' bit for bit, micro_fixed's
    and micro_fixed3's levels 1-2 also on random tile counts (the record
    stage), and K2's empty frame to the constant frame; then times each
    variant (a call, runs of 20, 30 queued, replayed from a CUDA graph,
    host us a call), its plain version and its library call, and computes
    its bound; then the host's cost of a call against the operand count
    and the binding's beside K1's wrapper (``k1_call``: K1's args and
    kwargs).  Returns a dict: ``variants`` {(module, label): times},
    ``launches`` (M1, M2, K1-K4), ``errors`` (the max abs error of each
    kernel against its plain version) and ``binding``."""
    from differential_projection_voxel_renderer_tpu_torch import _build
    from differential_projection_voxel_renderer_tpu_torch.benches import (
        common,
    )
    from differential_projection_voxel_renderer_tpu_torch.ops import (
        geometry,
        micro,
    )
    from differential_projection_voxel_renderer_tpu_torch.ops.raster import (
        SKY_I32,
    )

    t0 = time.perf_counter()
    variants = probe_variants()
    expect = [0] * 6
    outs = {}
    torch.cuda.synchronize()
    reset_counters()
    for name, mod, label, args in variants:
        v = mod.variant(label)
        before = probe_launches()
        outs[name, label] = (v, mod.run_variant(label, *args))
        got = tuple(a - b for a, b in zip(probe_launches(), before))
        k = {"M1": 0, "M2": 1, "K2": 3}[v.kernel]
        want = tuple(v.calls if i == k else 0 for i in range(6))
        if got != want:
            raise AssertionError(f"{name} {label} launched M1, M2, K1-K4 "
                                 f"{got}, expected {want}")
        expect[k] += v.calls
    torch.cuda.synchronize()
    launches = probe_launches()
    if launches != tuple(expect):
        raise AssertionError(f"probe launches {launches}, expected {expect}")
    log(f"[11] cost-probe path: {len(variants)} variants through "
        f"run_variant; launches M1={launches[0]} M2={launches[1]} "
        f"K2={launches[3]} (K1, K3, K4 none)")

    errs = {"M1": 0.0, "M2": 0.0, "K2": 0.0}
    for name, mod, label, args in variants:
        v, got = outs[name, label]
        ref = mod.run_variant(label, *args, plain=True)
        if not common.same_bits(v.written(got), v.written(ref)):
            raise AssertionError(f"{name} {label}: {v.kernel} differs from "
                                 f"its plain version")
        for a, b in zip(v.written(got), v.written(ref)):
            d = (a.double() - b.double()).abs()
            d = d[torch.isfinite(d)]
            if d.numel():
                errs[v.kernel] = max(errs[v.kernel], float(d.max()))
    for name in ("micro_fixed", "micro_fixed3"):
        mod = probe_modules()[name]
        inputs = mod.build_inputs(seed=11)
        for level in ("1", "2"):
            if not common.same_bits(mod.run_variant(level, inputs),
                                    mod.run_variant(level, inputs,
                                                    plain=True)):
                raise AssertionError(f"{name} level {level} on random tile "
                                     f"counts differs from its plain version")
    c3, d3 = outs["micro_fixed3", "3"][1]
    if not (bool((c3 == SKY_I32).all()) and bool(torch.isinf(d3).all())
            and bool((d3 > 0).all())):
        raise AssertionError("K2 on the empty stream is not the constant "
                             "frame")
    log(f"[11] every variant equal to its plain version bit for bit where "
        f"the kernel writes (micro_fixed and micro_fixed3 levels 1-2 also "
        f"on random tile counts); K2 on the empty 736x1280 stream gives the "
        f"constant frame (SKY, +inf)")

    rows = {}
    for name, mod, label, args in variants:
        v, got = outs[name, label]
        t = mod.time_variant(label, *args)
        t["plain_ms"] = median_ms(mod.prepare(label, *args, plain=True),
                                  reps=5)
        t["library_ms"] = median_ms(library_call(torch, v, got), batch=20)
        t["bound_ms"], t["bound_by"] = bound(v.bytes, 0)
        t.update(kernel=v.kernel, site=v.site, launches=v.calls,
                 bytes=v.bytes)
        rows[name, label] = t
        log(f"[11] {name} {label} ({v.kernel}, {v.site}): a call "
            f"{t['call_ms']:.4f} ms, runs of 20 {t['run_ms']:.4f}, 30 queued "
            f"{t['queued_ms']:.4f}, CUDA graph {t['graph_ms']:.4f}, host "
            f"{t['host_us']:.1f} us a call; plain "
            f"{t['plain_ms']:.4f}, library {t['library_ms']:.4f}, bound "
            f"{t['bound_ms']:.5f} ms ({v.bytes} bytes)")

    # host us a call against operand count, and the binding alone (the C
    # entry points called with prepared pointers), all in turns
    lib = _build.lib()
    args, kw = k1_call
    ins = geometry.kernel_inputs(*args)
    gout = geometry.kernel_outputs(ins[0].shape[0], ins[0].device)
    stream = torch.cuda.current_stream().cuda_stream
    k1_ptrs = (*(x.data_ptr() for x in ins), None, ins[0].shape[0],
               kw["width"], kw["height"], 1,
               *(x.data_ptr() for x in gout.values()), stream)
    cin = [torch.zeros((1024, 128), dtype=torch.int32, device="cuda")
           for _ in range(9)]
    xs = torch.zeros(1, dtype=torch.int32, device="cuda")
    m2_ptrs = (*(t.data_ptr() for t in cin[:4]), None, None, None, None,
               *(t.data_ptr() for t in cin[4:]), None, None, None,
               xs.data_ptr(), micro._copy_params(
                   1024, 64, 4, tuple((1, i, True) for i in range(5))),
               stream)
    m2mod = probe_modules()["micro_fixed2"]
    fns = {lab.split("_")[1]: m2mod.prepare(lab, PROBE_X)
           for lab in m2mod.SWEEP}
    fns.update({
        "K1 wrapper": lambda: geometry.project_cull(*args, **kw),
        "K1 C entry": lambda: lib.dpvr_project_cull(*k1_ptrs),
        "M2 C entry": lambda: lib.dpvr_blocked_copy(*m2_ptrs)})
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
        f"C entry alone (ctypes and launch, 16 arguments) "
        f"{host['K1 C entry']:.1f}; M2's wrapper at 4x5 {sweep['4x5']:.1f}, "
        f"its C entry alone (19 arguments) {host['M2 C entry']:.1f}; the "
        f"binding is {host['K1 C entry'] / host['K1 wrapper']:.2f} of K1's "
        f"wrapper call; K1's device time a call (131072 quads, from a CUDA "
        f"graph) {k1_graph * 1e3:.1f} us; {card}")
    binding = dict(k1_host_us=host["K1 wrapper"],
                   k1_bare_us=host["K1 C entry"],
                   m2_bare_us=host["M2 C entry"], sweep_us=sweep,
                   us_per_operand=slope, us_at_zero=icept,
                   k1_graph_ms=k1_graph)
    k2e = rows["micro_fixed3", "3"]
    log(f"[11] K2 on the empty 736x1280 stream: {k2e['call_ms']:.4f} ms a "
        f"call, {k2e['run_ms']:.4f} ms in runs of 20, {k2e['graph_ms']:.4f} "
        f"ms from a CUDA graph, {k2e['host_us']:.1f} us of host a call; "
        f"bound {k2e['bound_ms']:.5f} ms; {time.perf_counter() - t0:.1f} s "
        f"for phase 11; {card}")
    return dict(variants=rows, launches=launches, errors=errs,
                binding=binding)


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
        )
        from differential_projection_voxel_renderer_tpu_torch.ops import (
            geometry,
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
                ptxas[kernel] = rep
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
    if len(ptxas) != 5:
        raise AssertionError(f"ptxas reported {sorted(ptxas)}")
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
    words, fqw = fuzz_stream(torch, 131072)
    k1_args = (words, fqw, torch.tensor(120000, dtype=torch.int32,
                                        device="cuda"), vp, cp)
    n_valid, k1_err = k1_compare(torch, geometry, k1_args, gkw)
    log(f"[4] K1 fuzz 131072: bit-exact, {n_valid} valid")
    quads, qw, total = uploads
    n_valid, err = k1_compare(torch, geometry, (quads, qw, total, vp, cp),
                              gkw)
    k1_err = max(k1_err, err)
    log(f"[4] K1 vd12 stream ({quads.shape[0]} bucket, {int(total)} quads): "
        f"bit-exact, {n_valid} valid")

    # ---- 5. K2 vs twin, and the card vs the CPU on a small input
    k2_err = 0.0
    for name in parity.SMALL_SCENES:
        gargs, gkw2 = parity.small_scene(name, "cuda")
        cargs, ckw = parity.small_scene(name, "cpu")
        rec = pipeline.render_step(*gargs, debug_return_records=True, **gkw2)
        verdict, err, nmis = k2_compare(torch, raster, parity, rec,
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
    verdict, err, nmis = k2_compare(torch, raster, parity, rec720, HEIGHT,
                                    WIDTH)
    k2_err = max(k2_err, err)
    counts = rec720[2]
    log(f"[5] K2 1280x720 vd12: {verdict} ({nmis} colour mismatches); "
        f"{int(counts.sum())} items, max {int(counts.max())} per tile")

    # ---- 6. kernel and twin times at the vd12 shapes
    fk1 = (words, fqw, k1_args[2], vp, cp)
    k1_ms = median_ms(lambda: geometry.project_cull(*fk1, **gkw))
    k1_plain = median_ms(lambda: geometry.project_cull_plain(*fk1, **gkw))
    rkw = dict(height=HEIGHT, width=WIDTH, tile_h=16, tile_w=128,
               out_h=HEIGHT)
    k2_ms = median_ms(lambda: raster.rasterize_tiles(*rec720, **rkw))
    k2_plain = median_ms(lambda: raster.rasterize_tiles_plain(*rec720, **rkw))
    k1_run = median_ms(lambda: geometry.project_cull(*fk1, **gkw), batch=20)
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
    log_profile("7", "static frame", profile_frames(
        torch, lambda: eng.render_frame(dt=0.0)), frame["static_ms"], card)

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
    vd12 = (quads, qw, total, vp, cp)
    for label, nxt in (("fuzzed 131072-quad", fk1), ("vd12", vd12)):
        c3, d3, g3 = raster.rasterize_tiles(*rec720, next_geom=nxt, **rkw)
        if not (torch.equal(c3, c2) and torch.equal(d3, d2)):
            raise AssertionError(f"K3's frame differs from K2's ({label})")
        for ref in (geometry.project_cull(*nxt, **gkw),
                    geometry.project_cull_plain(*nxt, **gkw)):
            for k in ("valid", "bbx", "bby", "subpixel"):
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
            f"version's, bit for bit ({int(g3['valid'].sum())} valid)")
    def k3():
        return raster.rasterize_tiles(*rec720, next_geom=fk1, **rkw)

    def k2_k1():
        return (raster.rasterize_tiles(*rec720, **rkw),
                geometry.project_cull(*fk1, **gkw))

    k3_ms, k21_ms = median_ms(k3), median_ms(k2_k1)
    k3_run, k21_run = median_ms(k3, batch=20), median_ms(k2_k1, batch=20)
    k3_plain = median_ms(lambda: (
        raster.rasterize_tiles_plain(*rec720, **rkw),
        geometry.project_cull_plain(*fk1, **gkw)), reps=5)
    log(f"[9] K3 (vd12 records, 131072-quad next stream): {k3_ms:.4f} ms a "
        f"call, {k3_run:.4f} ms in runs of 20; K2 + K1 launches "
        f"{k21_ms:.4f} ms a call, {k21_run:.4f} ms in runs of 20 (medians "
        f"of 20); plain version {k3_plain:.4f} ms (median of 5); {card}")

    # ---- bounds, from this run's inputs
    k1_bytes, k1_ops = k1_work(fk1, geometry.project_cull(*fk1, **gkw))
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    boxes = item_boxes(torch, pipeline, (quads, qw, total, static_cam),
                       step_kw, rec720)
    k2_bytes, k2_ops, k2_tile_ops, k2_evaluated, k2_needed, k2_walk = k2_work(
        torch, raster, rec720, boxes, HEIGHT, WIDTH)
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
    del serial
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
    k2_run10 = median_ms(lambda: raster.rasterize_tiles(*rec720, **rkw),
                         batch=20)
    k4_plain = median_ms(lambda: raster_packed.rasterize_packed_plain(
        *recp[:5], **pkw), reps=5)
    boxes_p = item_boxes(torch, pipeline, (quads, qw, total, static_cam),
                         pstep_kw, recp)
    w4 = k4_work(torch, raster_packed, recp, boxes_p, HEIGHT, WIDTH)
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
        f"{k4_run:.4f} ms in runs of 20 (medians of 20); K2 on the default "
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
    log(f"[11] K2's floor: on the empty stream {k2e['run_ms']:.4f} ms in "
        f"runs of 20 ({k2e['call_ms']:.4f} a call, {k2e['graph_ms']:.4f} "
        f"from a CUDA graph), at vd12 {k2_run:.4f} ms in runs ({k2_ms:.4f} "
        f"a call, phase 6; {k2_graph:.4f} from a CUDA graph): the empty "
        f"floor is {k2e['run_ms'] / k2_run:.2f} of it in runs, "
        f"{k2e['graph_ms'] / k2_graph:.2f} of its device time; {card}")
    m1, m2 = rows11["micro_fixed2", "a_base"], rows11["micro_fixed2",
                                                      "solo10_4x5"]
    sites = {k: sorted({r["site"] for r in rows11.values()
                        if r["kernel"] == k}) for k in ("M1", "M2")}

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
             library_ms=None),
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
             empty_library_ms=k2e["library_ms"]),
        dict(name="K3 tile raster + next frame's stage A "
                  "(rasterize_tiles next_geom)", route="cuda",
             source=f"{PKG}/csrc/raster.cu",
             replaces=f"{REF}/ops/raster.py:678",
             launches=launches8[2], max_abs_err=k3_err, ms=k3_run,
             plain_ms=k3_plain, bound_ms=k3_bound, bound_by=k3_by,
             library_ms=None, tile_bound_ms=k3_tile_ms,
             k2_plus_k1_ms=k21_run),
        dict(name="K4 packed tile raster (rasterize_packed)", route="cuda",
             source=f"{PKG}/csrc/raster_packed.cu",
             replaces=f"{REF}/ops/raster_packed.py:205",
             launches=launches10[3], max_abs_err=k4_err, ms=k4_run,
             plain_ms=k4_plain, bound_ms=k4_bound, bound_by=k4_by,
             library_ms=None, tile_bound_ms=k4_tile_ms,
             k2_same_frame_ms=k2_run10,
             registers=ptxas["raster_packed_kernel"]["registers"],
             spill_bytes=ptxas["raster_packed_kernel"]["spill_stores"],
             blocks_per_sm=blocks["raster_packed_kernel"],
             split_ms=k4_phase_ms),
        dict(name="M1 constant tile fill (fill_tiles), at a_base",
             route="cuda", source=f"{PKG}/csrc/micro.cu",
             replaces="benches/micro_fixed2.py:65",
             launches=launches11[0], max_abs_err=probes["errors"]["M1"],
             ms=m1["run_ms"],
             plain_ms=m1["plain_ms"], bound_ms=m1["bound_ms"],
             bound_by=m1["bound_by"], library_ms=m1["library_ms"],
             call_ms=m1["call_ms"], queued_ms=m1["queued_ms"],
             graph_ms=m1["graph_ms"], host_us=m1["host_us"],
             replaces_all=sites["M1"],
             registers=ptxas["fill_tiles_kernel"]["registers"],
             spill_bytes=ptxas["fill_tiles_kernel"]["spill_stores"]),
        dict(name="M2 blocked copy (blocked_copy), at make9 4x5",
             route="cuda", source=f"{PKG}/csrc/micro.cu",
             replaces="benches/micro_fixed2.py:678",
             launches=launches11[1], max_abs_err=probes["errors"]["M2"],
             ms=m2["run_ms"],
             plain_ms=m2["plain_ms"], bound_ms=m2["bound_ms"],
             bound_by=m2["bound_by"], library_ms=m2["library_ms"],
             call_ms=m2["call_ms"], queued_ms=m2["queued_ms"],
             graph_ms=m2["graph_ms"], host_us=m2["host_us"],
             replaces_all=sites["M2"],
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

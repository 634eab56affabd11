#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two CUDA kernels from ``csrc/`` (nvcc, sm_90a), drives the
default frame path of ``Engine.render_frame`` at the headline scene
(1280x720, view distance 12, textures and shading on, from the reference
start pose), holds each kernel against its plain PyTorch twin on the card,
and times kernels and frames.  Phases:

1. environment (torch, CUDA, nvcc, the card's name and power limit);
2. kernel build;
3. the main path: world streamed until settled, prime(), 3 static frames
   (render_fused, then render_prepared), 50 timed static frames, then 10
   moving frames that stream chunks (render_fused_insert where the remesh
   batch fits its payload, else render_fused).  The kernels' launch counters are zeroed before it and read
   after it; both must grow on every frame, and the stats must show no
   overflow;
4. K1 (stage A) vs its twin, bit-exact on all five outputs: a fuzzed
   131072-quad stream and the real vd12 stream;
5. K2 (tile raster) vs its twin on the port's own records at 128x128,
   640x128 and 1280x720: full-frame equality, or the boundary-verified
   gate with its mismatch count; and the 128x128 frame on the card vs the
   same step on the CPU (the twins);
6. kernel and twin times at the vd12 shapes, median of 20 runs each;
7. the static frame's device time under torch.profiler: the card's busy
   time per frame, its idle share and the largest device activities.

The script imports the port package and nothing else of the repo (the port
shares the reference package's jax-free host layers); it checks that no
jax module was loaded before it prints its result.  Every number
printed comes from this run.  The line before the last is
JSON with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
when there is no CUDA device or the package is not beside this script.
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


def median_ms(fn, reps: int = 20) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after one warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nonsky(color) -> int:
    from differential_projection_voxel_renderer_tpu_torch.ops.raster import (
        SKY_I32,
    )

    return int((color != SKY_I32).sum())


def counters():
    from differential_projection_voxel_renderer_tpu_torch.ops import (
        geometry,
        raster,
    )

    return geometry.launches, raster.launches


def reset_counters() -> None:
    from differential_projection_voxel_renderer_tpu_torch.ops import (
        geometry,
        raster,
    )

    geometry.launches = 0
    raster.launches = 0


# ------------------------------------------------------------- main path


def main_path(torch):
    import numpy as np

    from differential_projection_voxel_renderer_tpu_torch.app.engine import (
        Engine,
        RenderConfig,
        WorldConfig,
    )

    t0 = time.perf_counter()
    eng = Engine(RenderConfig(WIDTH, HEIGHT),
                 WorldConfig(view_distance=VIEW_DISTANCE), device="cuda")
    eng.camera.position = np.array(START_POS, np.float32)
    eng.camera.look_at(np.array(START_TARGET, np.float32))
    while eng.world.update(eng.camera.position):
        pass
    t1 = time.perf_counter()
    eng.prime()
    t2 = time.perf_counter()
    log(f"[3] world: {eng.world.chunk_count()} chunks in {t1 - t0:.1f} s; "
        f"prime: {len(eng.pool.by_pos)} meshes in {t2 - t1:.1f} s")

    entry = {}
    for name in ("render_fused", "render_prepared", "render_fused_insert"):
        def wrap(fn, name=name):
            def call(*a, **kw):
                out = fn(*a, **kw)
                if out is not None:
                    entry[name] = entry.get(name, 0) + 1
                return out
            return call
        setattr(eng.renderer, name, wrap(getattr(eng.renderer, name)))

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
    for i in range(3):
        res, st, n = frame(True)
        log(f"[3] static frame {i}: stats={st.tolist()} non-sky={n} "
            f"entry={dict(entry)}")
    # the static draw list's stream and camera, for the kernel checks
    static = (eng._upload_cache[1], eng.camera.view_projection_matrix(),
              eng.camera.position.copy())
    n_timed = 50
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    h0 = time.perf_counter()
    ev0.record()
    for _ in range(n_timed):
        frame(False)
    ev1.record()
    ev1.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3 / n_timed
    dev_ms = ev0.elapsed_time(ev1) / n_timed
    # moving frames: creep forward and yaw 0.75 degrees a frame, so that
    # loaded but not yet meshed chunks turn visible a few at a time and
    # stream in as remesh batches small enough for the fused insert
    pos = np.array(START_POS, np.float32)
    look = np.array(START_TARGET, np.float32) - pos
    for i in range(10):
        pos[2] -= 2.0
        a = np.radians(0.75 * (i + 1))
        rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]], np.float32)
        eng.camera.position = pos.copy()
        eng.camera.look_at(pos + rot @ look)
        res, st, n = frame(True)
        log(f"[3] moving frame {i}: stats={st.tolist()} non-sky={n} "
            f"meshes={len(eng.pool.by_pos)} entry={dict(entry)}")
    torch.cuda.synchronize()
    launches = counters()
    frames = 3 + n_timed + 10
    if launches != (frames, frames):
        raise AssertionError(f"launches {launches} for {frames} frames")
    if not entry.get("render_fused_insert"):
        raise AssertionError(f"no frame took render_fused_insert: {entry}")
    log(f"[3] main path: {frames} frames, launches K1={launches[0]} "
        f"K2={launches[1]}, entry points {entry}")
    log(f"[3] static frame: {dev_ms:.3f} ms/frame between CUDA events, "
        f"{host_ms:.3f} ms/frame host clock (mean of {n_timed})")
    return eng, static, launches, dict(static_ms=dev_ms, host_ms=host_ms)


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


def profile_frames(torch, eng, n: int = 10):
    """Device time of ``n`` static frames under torch.profiler.

    Returns (busy ms/frame: the union of the intervals of every device
    activity, summed device ms/frame, activities/frame, wall ms/frame of
    the profiled frames between CUDA events, [(ms/frame, name)] largest
    first), or None when the profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng.render_frame(dt=0.0)
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ev0.record()
        for _ in range(n):
            eng.render_frame(dt=0.0)
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
    return busy / n / 1e3, total / n / 1e3, len(spans) / n, wall, top


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
        from differential_projection_voxel_renderer_tpu_torch.ops import (
            geometry,
            raster,
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
    secs = _build.build(force=True, verbose=True)
    _build.lib()
    log(f"[2] built {_build.LIB_PATH} in {secs:.1f} s")

    # ---- 3. main path
    eng, (uploads, vp0, cp0), launches, frame = main_path(torch)

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
    log(f"[6] K1 131072 quads: kernel {k1_ms:.4f} ms, twin {k1_plain:.4f} ms"
        f" (median of 20; {card})")
    log(f"[6] K2 1280x720 vd12 records: kernel {k2_ms:.4f} ms, twin "
        f"{k2_plain:.4f} ms (median of 20; {card})")
    log(f"[6] static frame {frame['static_ms']:.3f} ms (CUDA events), "
        f"{frame['host_ms']:.3f} ms host clock; {card}")

    # ---- 7. where a static frame's device time goes
    prof = profile_frames(torch, eng)
    if prof is None:
        log("[7] device time: not measured (the profiler saw no device "
            "activity)")
    else:
        busy, total, acts, wall, top = prof
        log(f"[7] static frame under torch.profiler (10 frames): device busy "
            f"{busy:.4f} ms/frame (union of {acts:.0f} device activities; "
            f"their sum {total:.4f} ms), wall {wall:.3f} ms/frame profiled; "
            f"idle share {1 - busy / wall:.3f} of the profiled frame, "
            f"{1 - busy / frame['static_ms']:.3f} of the unprofiled "
            f"{frame['static_ms']:.3f} ms; {card}")
        for ms, name in top[:10]:
            log(f"[7]   {ms:.4f} ms/frame  {name}")

    if "jax" in sys.modules:
        raise AssertionError("a module of the run imported jax")

    kernels = [
        dict(name="K1 stage A (project_cull)", route="cuda",
             source=f"{PKG}/csrc/geometry.cu",
             replaces=f"{REF}/ops/geometry_pallas.py:73",
             launches=launches[0], max_abs_err=k1_err, ms=k1_ms,
             plain_ms=k1_plain),
        dict(name="K2 tile raster (rasterize_tiles)", route="cuda",
             source=f"{PKG}/csrc/raster.cu",
             replaces=f"{REF}/ops/raster.py:1131",
             launches=launches[1], max_abs_err=k2_err, ms=k2_ms,
             plain_ms=k2_plain),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

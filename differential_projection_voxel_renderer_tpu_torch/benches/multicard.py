"""The sharded render on the cards present (``parallel/sharded_render.py``).

    python -m differential_projection_voxel_renderer_tpu_torch.benches.multicard [--runs N]

Run from the root of a checkout: it imports that checkout's
``chip_smoke`` for phase 3's engine and poses (``chip_smoke.new_engine``,
``chip_smoke.moving_poses``: 1280x720, view distance 12, textures and
shading on, the 4096-slot pool of 4096 quads a slot).  It renders phase
3's static frame and moving frames and keeps the static pose and the
moving poses ``MOVING_DP`` (the last one included) with their frames,
draw lists and cameras; phase 19 of ``chip_smoke.py`` calls ``run`` on
phase 3's own engine and frames instead.

On every card, from the main thread (whose current device is card 0), K1,
K2 with ``y0_px``, K3, K4, M1 and M2 launch on a copy of card 0's inputs
and must equal card 0's outputs bit for bit, each launched once on its
card by its wrapper; the kernel library's own runtime must see each card
as its current device inside ``torch.cuda.device`` (``kernel_checks``).

On four or more cards:

- what K1's and K4's C entries do on card 1's tensors when called from
  card 0's thread without the device guard (``unguarded_launch``);
- the 2 x 2 render (``make_sharded_render`` on ``make_mesh(4)``) of the
  static and the last moving pose, two 360-row bands a camera, the scene
  replicated on each card once: each camera's stacked bands equal phase
  3's frame of its pose bit for bit (colour, and depth as int32) at the
  first call, which runs each card's step eagerly and captures its graph,
  and at a replay (each card's K1 and K2 also by the device index of a
  ``torch.profiler`` trace), K1 and K2 counted once on each card at both
  (a graph's launches are counted at each replay, rendering/graphs.py),
  and the all-reduced count
  equal to the bands' sum // tp on both tp cards of each dp row;
- ``Engine.render_views`` on ``make_mesh(4)`` (``views_entry``): two
  views a call, static and moving across a chunk boundary, each view
  equal to ``render_frame``'s frame of its pose bit for bit, the pool's
  replicas following it;
- ``make_sharded_render_dp`` on the four cards, the static pose and the
  three moving poses, one camera a card: each frame equal to phase 3's;
- times, host clock around a call and the synchronisation of every card,
  in turns (the order reversed every other turn) over ``--runs`` turns:
  each layout's batch on the four cards against the same batch on card 0
  alone (phase 13's path: the mesh lists card 0 four times); the 2 x 2
  bands from the graphs against the eager steps from this thread, from a
  thread a card, and on one card; the gather alone, the all-reduce alone,
  and each card's K2 on its band (CUDA events, in runs of 20).

On fewer cards it runs the 1 x 1 mesh and the per-card kernel checks, and
says that the four-card layouts were not run.  It prints one JSON line
(``"ok"``: every check passed) and each card's name and power limit
(nvidia-smi), and returns 0 when every check passed.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from .. import _build
from ..ops import geometry, raster, raster_packed
from ..parallel import sharded_render as sr
from ..rendering import graphs, pipeline
from . import common, micro_fixed2

# phase 3's moving frames (0-based) whose poses join the static pose in
# the camera batch; the last is the last moving pose, the 2 x 2 layout's
# second camera
MOVING_DP = (3, 6, 9)
# the probes' variants of M1 and M2 checked on each card (chip_smoke.py's)
M1_LABEL, M2_LABEL = "a_base", "solo10_4x5"
# the views check's moving calls: 2 world units a call from the start pose
# (z = 20) to z = -4, across the chunk boundary at z = 0
VIEWS_MOVING = 12


def log(msg: str) -> None:
    print(f"[multicard] {msg}", file=sys.stderr, flush=True)


def smi() -> list[str]:
    """Each card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def sync_all() -> None:
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


def same_frame(got, ref) -> bool:
    """Colour equal, depth equal as int32 bits."""
    return (torch.equal(got[0], ref[0])
            and torch.equal(got[1].view(torch.int32),
                            ref[1].view(torch.int32)))


def phase3_poses(smoke):
    """Phase 3's engine and its poses, as ``run`` takes them: a new engine
    settled and primed at the start pose, its static frame, then the
    moving frames; returns (engine, [(frame, draw list, (view_proj,
    cam_pos))] for the static pose and each of ``MOVING_DP``)."""
    eng = smoke.new_engine(torch)[0]

    def frame():
        r = eng.render_frame(dt=0.0)
        return ((r.color.clone(), r.depth.clone(), r.stats.clone()),
                eng.draw_list(),
                (eng.camera.view_projection_matrix(),
                 eng.camera.position.copy()))

    poses = [frame()]
    for i, (pos, target) in enumerate(smoke.moving_poses()):
        eng.camera.position = pos
        eng.camera.look_at(target)
        f = frame()
        if i in MOVING_DP:
            poses.append(f)
    return eng, poses


def batch_args(eng, lists, cams) -> tuple[tuple, dict]:
    """The sharded render's inputs for the cameras ``cams`` ((view_proj,
    cam_pos) each) with draw lists ``lists`` (``Engine.draw_list``'s, of
    frames rendered on ``eng``'s pool) on its device: ((pool, counts,
    positions, visible slots, n_visible, view_proj, cam_pos), its caps:
    gather_cap the largest list's quads rounded up to a power of two (at
    least the engine's), render_cap and tile_k_cap the engine's)."""
    cfg = eng.config
    visible = np.stack([dl.slots for dl in lists]).astype(np.int32)
    nvis = np.array([dl.n for dl in lists], np.int32)
    most = max(int(eng.pool.counts[dl.slots[:dl.n]].sum()) for dl in lists)
    caps = dict(gather_cap=max(cfg.gather_cap, 1 << (most - 1).bit_length()),
                render_cap=cfg.quads_cap, tile_k_cap=cfg.tile_k_cap)
    dev = eng.device
    args = (eng.pool.quads, torch.from_numpy(eng.pool.counts).to(dev),
            torch.from_numpy(eng.pool.positions).to(dev),
            torch.from_numpy(visible).to(dev), torch.from_numpy(nvis).to(dev),
            torch.from_numpy(np.stack([c[0] for c in cams])).to(dev),
            torch.from_numpy(np.stack([c[1] for c in cams])).to(dev))
    return args, caps


def dp_streams(eng, args, gather_cap: int) -> list:
    """Each camera's gathered stream (quads, quad_world, total) from
    ``batch_args``' inputs, its draw list expanded with every face
    direction: the inputs of ``make_sharded_render_dp``."""
    pool_q, _, positions, visible, nvis = args[:5]
    dev = pool_q.device
    vcap = visible.shape[1]
    ones = torch.ones((vcap, 6), dtype=torch.int32, device=dev)
    counts6 = torch.from_numpy(eng.pool.counts6).to(dev)
    out = []
    for i in range(visible.shape[0]):
        sl = visible[i].long()
        c6 = torch.where(torch.arange(vcap, device=dev)[:, None] < nvis[i],
                         counts6[sl], 0)
        out.append(pipeline._expand_uploads_impl(
            pool_q, visible[i], c6, ones, positions[sl], gather_cap))
    return out


def kernel_checks(stream, step_kw, cards: int, band: tuple[int, int]
                  ) -> dict:
    """K1, K2 with ``y0_px`` (rows ``band`` = (y0, band_h)), K3, K4, M1
    and M2 on each of ``cards`` cards, called from this thread (current
    device card 0) on copies of card 0's inputs: each launched once on its
    card by its wrapper (``_build.card_launches``) and equal to card 0's
    outputs bit for bit.  ``stream`` = (quads, quad_world, n_quads,
    view_proj, cam_pos) on card 0, ``step_kw`` the render step's keywords.
    Also the kernel library's current device, from this thread and inside
    ``torch.cuda.device(k)``.  Returns {"current_device": [...],
    "launches": {card: {kernel: n}}}; raises on a mismatch."""
    if torch.cuda.current_device() != 0:
        raise AssertionError("the checks run from a thread on card 0")
    y0, bh = band
    h, w = step_kw["height"], step_kw["width"]
    band_rec = pipeline.render_step(*stream, band_y0=y0, band_h=bh,
                                    debug_return_records=True, **step_kw)
    rec = pipeline.render_step(*stream, debug_return_records=True, **step_kw)
    prec = pipeline.render_step(*stream, debug_return_records=True,
                                **dict(step_kw, packed_raster=True))
    rkw = dict(height=h, width=w, tile_h=16, tile_w=128)

    def calls(k):
        def to(xs):
            return [x.to(k) if isinstance(x, torch.Tensor) else x
                    for x in xs]
        s = to(stream)
        k1 = geometry.project_cull(*s, width=w, height=h)
        k2 = raster.rasterize_tiles(*to(band_rec), out_h=-bh % 16 + bh,
                                    y0_px=y0, **rkw)
        k3 = raster.rasterize_tiles(*to(rec), out_h=h, next_geom=s, **rkw)
        k4 = raster_packed.rasterize_packed(*to(prec), height=h, width=w)
        m1, m2 = (micro_fixed2.variant(label).written(
            micro_fixed2.run_variant(label, 7, device=f"cuda:{k}"))
            for label in (M1_LABEL, M2_LABEL))
        return dict(K1=tuple(k1.values()), K2=k2, K3=(*k3[:2],
                    *k3[2].values()), K4=k4, M1=m1, M2=m2)

    lib = _build.lib()
    current = [lib.dpvr_current_device()]
    out0 = None
    launches = {}
    for k in range(cards):
        _build.reset_counts()
        got = calls(k)
        torch.cuda.synchronize(k)
        launches[k] = {name: n for (name, card), n
                       in _build.card_launches.items() if card == k}
        others = {key: n for key, n in _build.card_launches.items()
                  if key[1] != k}
        if launches[k] != dict(K1=1, K2=1, K3=1, K4=1, M1=1, M2=1) or others:
            raise AssertionError(f"card {k}: launches "
                                 f"{dict(_build.card_launches)}")
        with torch.cuda.device(k):
            current.append(lib.dpvr_current_device())
        if out0 is None:
            out0 = got
            continue
        for name, outs in got.items():
            if not common.same_bits([x.to(0) for x in outs], out0[name]):
                raise AssertionError(f"{name} on card {k} differs from its "
                                     f"output on card 0")
    if current != [0, *range(cards)]:
        raise AssertionError(f"the kernel library's current device {current}"
                             f", expected 0 then each card")
    return dict(current_device=current, launches=launches)


# K1's and K4's C entries on card 1's tensors and stream, called from a
# thread whose current device is card 0 without the device guard of
# ``_build.launch``, then the same calls with it; run in a process of its
# own (so K4's first call there is this one, and whatever the calls do to
# a CUDA context stays there)
_UNGUARDED = """
import json
import torch
from differential_projection_voxel_renderer_tpu_torch import _build
from differential_projection_voxel_renderer_tpu_torch.benches import k1_call
from differential_projection_voxel_renderer_tpu_torch.ops import geometry
lib, dev, n = _build.lib(), torch.device("cuda", 1), 8192
words, qw = k1_call.fuzz_stream(torch, n)
stream = (words.to(dev), qw.to(dev), torch.tensor(n, dtype=torch.int32,
          device=dev), torch.eye(4, device=dev), torch.zeros(3, device=dev))
out = geometry.kernel_outputs(n, dev)
torch.cuda.synchronize(1)
raw = torch._C._cuda_getCurrentRawStream(1)
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    k1 = lib.dpvr_project_cull(
        *geometry.kernel_args(*stream), None, n, 256, 128,
        geometry.BACKFACE, *geometry.output_ptrs(out), None, raw)
    torch.cuda.synchronize(0)
    torch.cuda.synchronize(1)
ran_on = sorted({e.device_index for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "project_cull_kernel" in e.name})
ref = geometry.project_cull(*stream, width=256, height=128)
z = torch.zeros(24 * 2048, dtype=torch.int32, device=dev)
frame = torch.empty(2 * 16 * 128, dtype=torch.int32, device=dev)
k4 = [lib.dpvr_rasterize_packed(
    z.data_ptr(), 2048, z.data_ptr(), z.data_ptr(), z.data_ptr(),
    z.data_ptr(), z.data_ptr(), 1, 1, 16, 128, frame.data_ptr(),
    frame[2048:].data_ptr(), raw)]
with torch.cuda.device(1):
    k4.append(lib.dpvr_rasterize_packed(
        z.data_ptr(), 2048, z.data_ptr(), z.data_ptr(), z.data_ptr(),
        z.data_ptr(), z.data_ptr(), 1, 1, 16, 128, frame.data_ptr(),
        frame[2048:].data_ptr(), raw))
torch.cuda.synchronize(1)
print(json.dumps(dict(
    current_device=torch.cuda.current_device(), k1_error=k1,
    k1_ran_on=ran_on, stream_handle=raw,
    k1_equals_guarded=all(torch.equal(out[k], ref[k]) for k in ref),
    k4_error=k4[0], k4_guarded_error=k4[1])))
"""


def unguarded_launch() -> dict:
    """What K1's and K4's C entries do when they are called on card 1's
    tensors and stream from a thread whose current device is card 0,
    without ``_build.launch``'s guard, and K4's with it (in a process of
    its own): the cudaErrors, the card K1's kernel ran on (the profiler's
    device index), the stream handle passed (PyTorch's default stream is
    the null stream, which means the current card's), and whether K1's
    outputs equal its guarded wrapper's."""
    p = subprocess.run([sys.executable, "-c", _UNGUARDED],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(_build._PKG))
    if p.returncode != 0:
        return dict(rc=p.returncode, stderr=p.stderr[-400:])
    return json.loads(p.stdout.splitlines()[-1])


def wall_ms(fn) -> float:
    """Host milliseconds of ``fn()`` and the synchronisation of every
    card, from a synchronised start."""
    sync_all()
    t0 = time.perf_counter()
    fn()
    sync_all()
    return (time.perf_counter() - t0) * 1e3


def kernel_device_counts(fn) -> dict:
    """{card: {"K1": n, "K2": n}} of the K1 and K2 kernels that ``fn()``
    ran, by the device index of each in a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync_all()
    by_card = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = ("K1" if "project_cull_kernel" in e.name
                else "K2" if "raster_kernel" in e.name
                and "packed" not in e.name else None)
        if name:
            card = by_card.setdefault(e.device_index, {})
            card[name] = card.get(name, 0) + 1
    return by_card


def replayed_graphs(fn) -> dict:
    """A sharded render's graphs by shard: (its CapturedCall, its CUDA
    graph), compared by identity before and after a replay."""
    return {k: (g, g.graph) for k, g in fn.shards.graphs.items()}


def counted(fn, cards: int) -> tuple:
    """``fn()`` with the per-card counts zeroed before and read after:
    (its result, {card: (K1, K2) launches}, all launches (a step's are K1,
    tile_meta and K2), the CUDA-graph captures and replays it made)."""
    sync_all()
    _build.reset_counts()
    calls = graphs.calls.copy()
    out = fn()
    sync_all()
    got = dict(_build.card_launches)
    return (out, {k: (got.get(("K1", k), 0), got.get(("K2", k), 0))
                  for k in range(cards)}, sum(got.values()),
            graphs.calls - calls)


def eager_bands(fn, args, threads=None) -> None:
    """The 2 x 2 render's shards by their eager steps (``fn.step``), each
    on its card: from this thread in turn, or with ``threads`` ({card: a
    one-thread executor whose thread's current device is that card}) from
    a thread a card (the design the graphs replaced: see
    ``parallel/sharded_render.py``)."""
    scene = [x if isinstance(x, sr.Replicated) else sr.replicate(fn.mesh, x)
             for x in args[:3]]
    dp, tp = fn.mesh
    per = args[3].shape[0] // dp

    def shard(i, t):
        dev = fn.mesh.devices[i, t]
        return fn.step((i, t), *(x.on(dev) for x in scene), *(
            x[i * per:(i + 1) * per].to(dev) for x in args[3:]))

    keys = [(i, t) for i in range(dp) for t in range(tp)]
    if threads is None:
        for key in keys:
            shard(*key)
        return
    futures = [threads[fn.mesh.devices[key].index].submit(shard, *key)
               for key in keys]
    for f in futures:
        f.result()


def in_turns(fns: dict, runs: int) -> dict:
    """``runs`` turns over ``fns`` ({name: fn}), the order reversed every
    other turn, by ``wall_ms``: {name: [ms]}."""
    times = {k: [] for k in fns}
    for r in range(runs):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[k].append(wall_ms(fns[k]))
    return times


def views_entry(smoke, cards: int, log=log) -> dict:
    """``Engine.render_views`` on ``make_mesh(cards)`` (2 x 2 on four
    cards) against ``render_frame``: a views engine and a serial engine of
    phase 3's configuration (``smoke.new_engine``), each settled and primed
    at the start pose; the views engine's ``warm_views`` captures every
    bucket on every card.  Then two views a call, back to back (the second
    yaw + pi): the static start pose, and ``VIEWS_MOVING`` poses creeping
    from it across the chunk boundary at z = 0, so that chunks stream in,
    mesh and land in the pool between calls.  The serial engine renders
    each view at the same pose, in the same order (its world updates at a
    call's first view only, as the views engine's): every view's stacked
    bands equal its frame bit for bit (colour, depth as int32) with its
    stream length, no cap drops, the reduced count alike on both tp cards,
    no call after ``warm_views`` captures, and after the moving calls each
    card's replica of the pool equals the pool.  Returns the readings."""
    ev = smoke.new_engine(torch, mesh_cards=cards)[0]
    es = smoke.new_engine(torch)[0]
    before = graphs.calls.copy()
    ev.warm_views(2)
    warm = graphs.calls - before
    start = np.array(smoke.START_POS, np.float32)
    ev.camera.look_at(np.array(smoke.START_TARGET, np.float32))
    yaw, pitch = ev.camera.yaw, ev.camera.pitch
    calls = [start] + [start - np.array([0.0, 0.0, 2.0 * (i + 1)],
                                        np.float32)
                       for i in range(VIEWS_MOVING)]
    res = dict(warm_graph_calls=dict(warm), calls=[])
    # the views calls' own graph calls (the serial engine captures its own)
    made = collections.Counter()
    for i, pos in enumerate(calls):
        views = [(pos, yaw + 0.01 * i, pitch),
                 (pos, yaw + 0.01 * i + np.pi, pitch)]
        before = graphs.calls.copy()
        got = ev.render_views(views)
        made += graphs.calls - before
        for k, (p, y, pt) in enumerate(views):
            es.camera.position = np.array(p, np.float32)
            es.camera.yaw, es.camera.pitch = y, pt
            es._hold_world = k > 0
            f = es.render_frame(dt=0.0)
            es._hold_world = False
            if not (same_frame((got.color[k], got.depth[k]), (f.color,
                                                              f.depth))
                    and int(got.stats[k, 0]) == int(f.stats[0])
                    and got.stats[k, 2:4].tolist() == [0, 0]
                    and len(set(got.reduced[k].tolist())) == 1):
                raise AssertionError(f"views: call {i} view {k} differs from "
                                     f"render_frame at its pose")
        res["calls"].append(dict(z=float(pos[2]), stats=got.stats.tolist(),
                                 reduced=got.reduced.tolist(),
                                 meshes=len(ev.pool.by_pos)))
    if made.get("captures") or warm.get("captures", 0) < 1:
        raise AssertionError(f"views: graph calls at warm_views {warm}, in "
                             f"the calls {made}")
    render = ev._views_render()
    sync_all()
    for d, rep in render._replicas.items():
        if not torch.equal(rep, ev.pool.quads.to(d)):
            raise AssertionError(f"views: the replica on {d} differs from "
                                 f"the pool")
    res["replicas_equal_pool"] = sorted(str(d) for d in render._replicas)
    res["calls_graph_calls"] = dict(made)
    log(f"views on {render.mesh}: {len(calls)} calls of two views (the "
        f"static start pose, then z down to {float(calls[-1][2])}), every "
        f"view's stacked bands equal render_frame's frame bit for bit; "
        f"{warm.get('captures')} captures in warm_views, none after; the "
        f"pool grew to {len(ev.pool.by_pos)} meshes and every replica "
        f"equals it")
    return res


def four_cards(eng, poses, args, dargs, caps, step_kw, runs: int,
               log=log) -> dict:
    """The 2 x 2 and the dp layouts on cards 0-3 (see the module's
    docstring): ``args`` the 2 x 2 batch's inputs and ``dargs`` the dp
    batch's (``batch_args`` of the two and of all the poses), ``caps``
    their caps; returns the checks' readings and the times."""
    from concurrent.futures import ThreadPoolExecutor

    res = dict(unguarded_launch=unguarded_launch())
    log(f"K1 and K4's C entries on card 1's tensors from card 0's thread "
        f"without the device guard: {res['unguarded_launch']}")
    mesh = sr.make_mesh(4)
    one = sr.make_mesh(4, devices=[mesh.devices[0, 0]] * 4)
    kw = dict(width=step_kw["width"], height=step_kw["height"])
    fn4 = sr.make_sharded_render(mesh, **kw, **caps)
    fn1 = sr.make_sharded_render(one, **kw, **caps)
    scene = [sr.replicate(mesh, x) for x in args[:3]]
    batch4 = (*scene, *args[3:])
    refs = [poses[0][0], poses[-1][0]]

    # the first call runs each card's step eagerly and captures its graph
    out, per_card, total, calls = counted(lambda: fn4(*batch4), 4)
    if (total != 12 or any(v != (1, 1) for v in per_card.values())
            or calls != {"captures": 4}):
        raise AssertionError(f"2x2: first call's launches {per_card}, "
                             f"graph calls {calls}")
    made = replayed_graphs(fn4)
    for i in range(2):
        if not same_frame((out[0][i], out[1][i]), refs[i]):
            raise AssertionError(f"2x2: camera {i}'s stacked bands differ "
                                 f"from phase 3's frame")
    out2, replay_card, total, calls = counted(lambda: fn4(*batch4), 4)
    # a replay of the graphs the first call captured, and no capture
    if (replay_card != per_card or total != 12 or calls != {"replays": 4}
            or replayed_graphs(fn4) != made or not all(
                same_frame((out2[0][i], out2[1][i]), refs[i])
                for i in range(2))):
        raise AssertionError(f"2x2: a replay counted {replay_card} and "
                             f"graph calls {calls}, or "
                             f"changed a frame")
    res["2x2_launches_k1_k2_by_card"] = per_card
    res["2x2_kernels_by_profiler"] = kernel_device_counts(
        lambda: fn4(*batch4))
    if res["2x2_kernels_by_profiler"] and any(
            res["2x2_kernels_by_profiler"].get(k) != dict(K1=1, K2=1)
            for k in range(4)):
        raise AssertionError(f"2x2: kernels by device index "
                             f"{res['2x2_kernels_by_profiler']}")
    log(f"2x2 on cards 0-3: both cameras' stacked bands equal phase 3's "
        f"frames bit for bit, at the capture and at a replay; K1, K2 "
        f"launches by card at the capture {per_card} (the eager step), at a "
        f"replay {replay_card}; kernels of a replay by the profiler's device "
        f"index "
        f"{res['2x2_kernels_by_profiler']}")

    shards = fn4.bands(*batch4)
    band = {key: s[2].cpu() for key, s in shards.items()}
    fn4.reduce(shards)
    sync_all()
    counts = {}
    for i in range(2):
        want = int(band[i, 0] + band[i, 1]) // 2
        got = [int(shards[i, t][2]) for t in range(2)]
        if got != [want, want]:
            raise AssertionError(f"dp row {i}: all-reduced counts {got}, "
                                 f"the bands' sum // tp {want}")
        counts[i] = dict(bands=[int(band[i, t]) for t in range(2)],
                         reduced=got)
    if out[2].tolist() != [c["reduced"][0] for c in counts.values()]:
        raise AssertionError(f"2x2: gathered counts {out[2].tolist()}")
    res["2x2_counts"] = counts
    log(f"2x2: all-reduced counts equal the bands' sum // 2 on both tp "
        f"cards of each dp row: {counts}")

    dkw = dict(kw, render_cap=caps["render_cap"],
               tile_k_cap=caps["tile_k_cap"])
    fnd4, _ = sr.make_sharded_render_dp(mesh, **dkw)
    fnd1, _ = sr.make_sharded_render_dp(one, **dkw)
    streams = dp_streams(eng, dargs, caps["gather_cap"])
    dbatch = (*(torch.stack([s[k] for s in streams]) for k in range(3)),
              *dargs[5:])
    dout, dp_card, total, _ = counted(lambda: fnd4(*dbatch), 4)
    if total != 12 or any(v != (1, 1) for v in dp_card.values()):
        raise AssertionError(f"dp: first call's launches {dp_card}")
    for i, p in enumerate(poses):
        if not same_frame((dout[0][i], dout[1][i]), p[0]):
            raise AssertionError(f"dp: camera {i} differs from phase 3's "
                                 f"frame")
    res["dp_launches_k1_k2_by_card"] = dp_card
    log(f"dp on cards 0-3: the 4 frames equal phase 3's bit for bit; K1, K2 "
        f"launches by card at the capture {dp_card}")

    threads = {k: ThreadPoolExecutor(1, initializer=torch.cuda.set_device,
                                     initargs=(k,)) for k in range(4)}
    try:
        fn1(*args)
        fnd1(*dbatch)
        t = in_turns({
            "2x2_4cards": lambda: fn4(*batch4),
            "2x2_1card": lambda: fn1(*args),
            "dp_4cards": lambda: fnd4(*dbatch),
            "dp_1card": lambda: fnd1(*dbatch)}, runs)
        e = in_turns({
            "bands_graphs_4cards": lambda: fn4.bands(*batch4),
            "bands_eager_4cards_one_thread": lambda: eager_bands(
                fn4, batch4),
            "bands_eager_4cards_thread_a_card": lambda: eager_bands(
                fn4, batch4, threads),
            "bands_eager_1card": lambda: eager_bands(fn1, args)}, runs)
    finally:
        for ex in threads.values():
            ex.shutdown()
    shards = fn4.bands(*batch4)
    fn4.reduce(shards)
    t["gather"] = [wall_ms(lambda: fn4.gather(shards)) for _ in range(runs)]
    row = [shards[0, k][2] for k in range(2)]
    t["all_reduce"] = [wall_ms(lambda: sr.all_reduce_sum(row))
                       for _ in range(runs)]
    t.update(e)
    med = {k: statistics.median(v) for k, v in t.items()}
    res["times_ms"] = dict(median=med, runs=t)
    log(f"host wall ms a call (median of {runs}, in turns): 2x2 on 4 cards "
        f"{med['2x2_4cards']:.3f}, on 1 card {med['2x2_1card']:.3f}; dp on 4 "
        f"cards {med['dp_4cards']:.3f}, on 1 card {med['dp_1card']:.3f}; "
        f"gather alone {med['gather'] * 1e3:.1f} us, all-reduce alone "
        f"{med['all_reduce'] * 1e3:.1f} us; the 2x2 bands from graphs "
        f"{med['bands_graphs_4cards']:.3f}, eager from one thread "
        f"{med['bands_eager_4cards_one_thread']:.3f}, eager from a thread a "
        f"card {med['bands_eager_4cards_thread_a_card']:.3f}, eager on one "
        f"card {med['bands_eager_1card']:.3f}")

    # each card's K2 on its band: the records of camera i's band t, made
    # on card 0 and copied to card i * 2 + t
    bh = step_kw["height"] // 2
    band_ms = {}
    rkw = dict(height=step_kw["height"], width=step_kw["width"], tile_h=16,
               tile_w=128, out_h=-bh % 16 + bh)
    for i in range(2):
        s = streams[-i]  # the static pose, then the last moving one
        cam = dargs[5][-i], dargs[6][-i]
        for t in range(2):
            k = i * 2 + t
            rec = pipeline.render_step(
                *s, *cam, band_y0=t * bh, band_h=bh,
                debug_return_records=True, **step_kw)
            rec_k = [x.to(k) for x in rec]
            ref = raster.rasterize_tiles(*rec, y0_px=t * bh, **rkw)
            with torch.cuda.device(k):
                got = raster.rasterize_tiles(*rec_k, y0_px=t * bh, **rkw)
                ms = common.median_ms(
                    lambda: raster.rasterize_tiles(
                        *rec_k, y0_px=t * bh, **rkw), batch=20)
            if not common.same_bits([x.to(0) for x in got], ref):
                raise AssertionError(f"K2 on card {k} differs from card 0's "
                                     f"on the same band")
            band_ms[f"card {k} (camera {i}, rows {t * bh}-"
                    f"{(t + 1) * bh - 1})"] = ms
    res["k2_band_ms"] = band_ms
    log("K2 on each card's band, ms a call in runs of 20: "
        + ", ".join(f"{k} {v:.4f}" for k, v in band_ms.items()))
    return res


def run(eng, poses, runs: int = 20, log=log) -> dict:
    """The checks and times of the module's docstring on ``eng`` (phase
    3's engine, on card 0) and ``poses`` (``phase3_poses``' list: the
    static pose first, the last moving pose last), each step reported
    through ``log``; raises when a check fails.  Returns a JSON-ready
    dict."""
    cards = torch.cuda.device_count()
    res = dict(cards=cards, smi=smi())
    dargs, caps = batch_args(eng, [p[1] for p in poses],
                             [p[2] for p in poses])
    two = [poses[0], poses[-1]]
    args, _ = batch_args(eng, [p[1] for p in two], [p[2] for p in two])
    cams = [p[2] for p in two]
    # the engine's step keywords (a serial engine: no near pass)
    step_kw = dict(eng.renderer._bucket_kw(caps["gather_cap"]),
                   render_cap=caps["render_cap"],
                   tile_k_cap=caps["tile_k_cap"])
    if step_kw.pop("near_quads"):
        raise ValueError("the sharded render runs a serial engine's step")
    h = step_kw["height"]
    stream = dp_streams(eng, args, caps["gather_cap"])[0]
    static_cam = tuple(torch.from_numpy(np.array(x, np.float32)).to(
        eng.device) for x in cams[0])
    res["kernel_checks"] = kernel_checks(
        (*stream, *static_cam), step_kw, cards, (h // 2, h // 2))
    log(f"K1, K2 (y0_px), K3, K4, M1, M2 on each of {cards} card(s) from "
        f"card 0's thread: each launched once on its card and equal to card "
        f"0's outputs; the kernel library's current device "
        f"{res['kernel_checks']['current_device']}")
    if cards < 4:
        fn = sr.make_sharded_render(sr.make_mesh(1), width=step_kw["width"],
                                    height=h, **caps)
        out, per_card, total, calls = counted(lambda: fn(*args), 1)
        # the first call: each camera's K1, tile_meta and K2 eagerly, then
        # captured
        if total != 6 or per_card[0] != (2, 2) or calls != {"captures": 1}:
            raise AssertionError(f"1x1: launches {per_card}, graph calls "
                                 f"{calls}")
        made = replayed_graphs(fn)
        # the second replays that graph: the same counts, no capture
        out2, per_card2, total, calls = counted(lambda: fn(*args), 1)
        if (total != 6 or per_card2 != per_card or calls != {"replays": 1}
                or replayed_graphs(fn) != made):
            raise AssertionError(f"1x1: a replay counted {per_card2} and "
                                 f"graph calls {calls}")
        res["1x1_launches_k1_k2_by_card"] = per_card
        for got in (out, out2):
            for i in range(2):
                if not same_frame((got[0][i], got[1][i]), two[i][0]):
                    raise AssertionError(f"1x1: camera {i} differs from "
                                         f"phase 3's frame")
        res["layouts"] = (f"1x1 mesh only: the four-card layouts need four "
                          f"cards and {cards} is present")
        log(f"1x1 mesh: both cameras equal phase 3's frames bit for bit, "
            f"at the capture and at a replay of the same graph; "
            f"the 2x2 and dp layouts on four cards were not run: {cards} "
            f"card(s) present")
        return res
    res.update(four_cards(eng, poses, args, dargs, caps, step_kw, runs,
                          log))
    import chip_smoke

    res["views"] = views_entry(chip_smoke, 4, log)
    res["layouts"] = "2x2 and dp on cards 0-3, and Engine.render_views"
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20)
    opts = ap.parse_args(argv)
    common.need_card()
    import chip_smoke as smoke

    eng, poses = phase3_poses(smoke)
    res = run(eng, poses, opts.runs)
    print(json.dumps(dict(res, ok=True)), flush=True)
    for line in res["smi"]:
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

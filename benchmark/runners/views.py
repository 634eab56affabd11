"""The runner of the views cells (``"runner": "views"``):
``Engine.render_views`` on an engine built with the configuration's
``engine_args`` (``mesh_cards``: the mesh of cards), driven by the
traffic's poses in a closed loop with at most ``outstanding`` calls in
flight.  A call renders one view a yaw of the traffic's ``view_yaws``
(its one key besides ``poses.Traffic``'s): each view is the traffic's
pose of the frame with that yaw added; a frame is one call.

Set-up is ``runners/engine.py``'s (settle, ``prime_all``) with
``warm_views`` in place of ``warm_buckets`` (the replicas, the NCCL
communicators and every gather bucket's graph on every card), then the
traffic's first ``warmup_frames`` calls.

For the comparison it keeps, at each sampled call, each view's outputs
(its frame, stats and the reduced count as each tp card holds it) and the
engine's public state: the loaded chunks, the pooled positions and the
pooled meshes of the chunks inside any view's sphere and frustum.  Its
``judge`` holds each view to the reference at that view's pose, and adds
two numbers of the exchange, each the worst over the views of every
sampled call:

- ``count_split``: the largest difference between the reduced counts of
  one view's tp cards; the all-reduce makes them equal, and without it
  each card holds its own band's count;
- ``band_count_diff``: |stats[1] - the reference's ``psum // tp``|
  (``reference/bands.py``).

``FAULTS``: the faults of the exchange, planted as ``faults.py``'s are
(``benchmark/control_views.py`` takes their readings)."""

from __future__ import annotations

import time

import numpy as np
import torch

# the entry this runner drives: a program without it fails here, at once
from differential_projection_voxel_renderer_tpu_torch.app.engine import (  # noqa: F401,E501
    ViewsResult)

from .. import correct, faults, poses
from ..clock import Clock
from ..reference import bands, funnel
from ..reference.frame import Reference
from ..trace import Profile, Spans
from . import engine as base


class Runner(base.Runner):
    def __init__(self, cell, seed: int, *, device="cuda",
                 trace: bool = False):
        params = dict(cell.traffic)
        self.view_yaws = [float(y) for y in params.pop("view_yaws")]
        self.cell, self.seed, self.trace = cell, seed, trace
        self.cfg = cell.config
        self.traffic = poses.Traffic(params, seed)
        self.device = torch.device(device)
        cards = int(self.cfg["engine_args"]["mesh_cards"])
        self.devices = ([torch.device("cuda", k) for k in range(cards)]
                        if self.device.type == "cuda" else [self.device])
        self.samples: list = []
        self.setup_info: dict = {}

    def poses(self, i: int) -> list:
        """Frame ``i``'s views: (position, yaw, pitch) each."""
        p = self.traffic.pose(i)
        return [(p.position, p.yaw + y, p.pitch) for y in self.view_yaws]

    def setup(self) -> None:
        """A context on every card, in order; the engine (settled and
        primed); ``warm_views``; the warm-up calls.  ``setup_info`` keeps
        each part's seconds and their sum (the rest of ``setup_s`` is the
        process's start and its imports)."""
        t0 = time.perf_counter()
        self._sync()
        t = time.perf_counter()
        self.setup_info["contexts_s"] = t - t0
        eng = self.eng = self._engine()
        self.setup_info["engine_s"] = (time.perf_counter() - t
                                       - self.setup_info["settle_prime_s"])
        t = time.perf_counter()
        eng.warm_views(len(self.view_yaws))
        self.setup_info["warm_views_s"] = time.perf_counter() - t
        self.first = self.traffic.warmup
        for i in range(self.first):
            eng.render_views(self.poses(i), dt=self.traffic.dt)
        self._sync()
        self.setup_info["warm_s"] = time.perf_counter() - t
        self.setup_info["setup_body_s"] = time.perf_counter() - t0

    def _sync(self) -> None:
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def wrap_spans(self, spans: Spans) -> None:
        """The traced run's spans: the entry (``render_views``), the
        world's update and the engine's meshing call."""
        eng = self.eng
        spans.wrap(eng, "render_views", "entry")
        spans.wrap(eng.world, "update", "world_update")

        def n_meshed(to_mesh, defer=False):
            return sum(1 for p in set(to_mesh) if p in eng.world.chunks)

        spans.wrap(eng, "_mesh_list", "meshing", count=n_meshed)

    def _call(self, k: int) -> ViewsResult:
        return self.eng.render_views(self.poses(self.first + k),
                                     dt=self.traffic.dt)

    def window(self, seconds: float, trace: bool) -> dict:
        """Calls for ``seconds``, at most ``outstanding`` in flight: a call
        waits for the completion mark (on the first card, after the
        gather) of the call ``outstanding`` before it."""
        clock = Clock(self.devices)
        outstanding = self.traffic.outstanding
        lim = self.cell.limits["sample"]
        sample_at = set(int(k) for k in poses.rng(self.seed, 2).integers(
            0, int(lim["range"]), size=int(lim["frames"])))
        spans = Spans() if trace else None
        if trace:
            self.wrap_spans(spans)
            p_first = int(self.cell.limits["trace"]["after_frames"])
            p_frames = int(self.cell.limits["trace"]["frames"])
        prof, profiled, stats = None, False, []
        issue, marks = [], []
        captures0 = base._captures()
        host = base.HostUse()
        t0 = clock.start()
        k = 0
        while (time.perf_counter() - t0 < seconds
               or (prof is not None and not profiled)):
            if k >= outstanding:
                if trace:
                    with spans.span("wait"):
                        clock.wait(marks[k - outstanding])
                else:
                    clock.wait(marks[k - outstanding])
            if trace and k == p_first:
                spans.active = False
                prof = PeerProfile().__enter__()
            issue.append(time.perf_counter() - t0)
            out = self._call(k)
            marks.append(clock.mark())
            if prof is not None and not profiled:
                stats.append(out.stats)
            if k in sample_at:
                self.samples.append(self._sample(k, out))
            if trace and k == p_first + p_frames - 1:
                clock.wait(marks[-1])
                prof.__exit__(None, None, None)
                profiled = spans.active = True
            if trace and spans.active:
                spans.frames += 1
            last = (k, out)
            k += 1
        clock.finish()
        self.setup_info["window_host"] = host.read()
        prof_info = {}
        if profiled:
            # the stream lengths of each profiled call's views
            prof_info = dict(prof.read(), frames=p_frames,
                             gathered=[int(s[:, 0].sum()) for s in stats])
        if not any(s["k"] == last[0] for s in self.samples):
            self.samples.append(self._sample(*last))
        done = [clock.seconds(m) for m in marks]
        lat_ms = [(d - s) * 1e3 for d, s in zip(done, issue)]
        return dict(frames=k, window_s=max(done), latencies_ms=lat_ms,
                    captures_in_window=base._captures() - captures0,
                    spans=spans, profile=prof_info)

    def _sample(self, k: int, res: ViewsResult) -> base.Sample:
        """Each view's outputs and the engine's public state after the
        call: the loaded chunks, the pooled positions, and the pooled
        meshes of the chunks inside any view's sphere and frustum."""
        eng, views = self.eng, self.poses(self.first + k)
        keys = list(eng.world.chunks)
        r = self.cfg["render"]
        pool = eng.pool
        pooled = set(pool.by_pos)
        held = {}
        for position, yaw, pitch in views:
            cam = funnel.camera_of(position, yaw, pitch, int(r["width"]),
                                   int(r["height"]))
            vis = funnel.visible_positions(
                np.asarray(keys, np.int64).reshape(-1, 3), cam.position,
                cam.extract_frustum(),
                int(self.cfg["world"]["view_distance"]))
            held.update((tuple(p), None) for p in vis.tolist()
                        if tuple(p) in pooled)
        held = list(held)
        slots = np.array([pool.by_pos[p] for p in held], np.int64)
        idx = torch.from_numpy(slots)
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        return base.Sample(
            k=k, views=[poses.Pose(tuple(float(c) for c in p), float(y),
                                   float(pt)) for p, y, pt in views],
            keys=keys, pooled=pooled, held=held,
            counts6=np.array(pool.counts6[slots], np.int64),
            rows=pool.quads.index_select(0, idx), color=res.color,
            depth=res.depth, stats=res.stats, reduced=res.reduced)


class PeerProfile(Profile):
    """``Profile`` that also reads the union of the peer copies' intervals
    (``Memcpy PtoP``: the gather's copies into the first card), in us."""

    def read(self) -> dict:
        from torch.autograd import DeviceType

        from .. import timing

        got = super().read()
        spans = [(e.time_range.start, e.time_range.end)
                 for e in self.prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "Memcpy PtoP" in e.name]
        if spans:
            got["peer_union_us"] = timing.busy_intervals(spans)[0]
        return got


def _views(sample: dict) -> list:
    """One sample a view, in the form ``correct.compare`` reads."""
    return [dict(sample, pose=pose, color=sample["color"][b],
                 depth=sample["depth"][b], stats=sample["stats"][b])
            for b, pose in enumerate(sample["views"])]


def judge(config: dict, samples: list, seed: int, limits: dict, device,
          dtype=torch.float64) -> tuple[bool, dict]:
    """(correct, {number: (value, limit)}) over every view of the sampled
    calls, the numbers those that the cell's limits name (the module's
    docstring and ``correct.py``)."""
    ref = Reference(config, device, dtype)
    step = int(limits["sample"]["row_step"])
    per = []
    for s in samples:
        first = correct.rows_of(seed, s, step)
        tp = int(np.asarray(s["reduced"]).shape[1])
        for b, view in enumerate(_views(s)):
            rf = correct.ref_frame(ref, view, first, step)
            nums = correct.compare(view, rf, first, step)
            red = np.asarray(s["reduced"][b], np.int64)
            want = bands.reduced_count(bands.stream_of(ref, rf,
                                                       view["pose"]), tp)
            nums.update(count_split=int(red.max() - red.min()),
                        band_count_diff=abs(int(view["stats"][1]) - want))
            per.append(nums)
            correct._log(s["k"], np.asarray(view["stats"]).tolist(), nums)
    got = correct.worst(per)
    lim = limits["limits"]
    table = {k: (got[k], lim[k]) for k in lim}
    return all(v <= m for v, m in table.values()), table


def control(config: dict, samples: list, seed: int, limits: dict, device,
            dtype=torch.bfloat16) -> dict:
    """The control's numbers: the reference computed in ``dtype`` put in
    the program's place in every view (its frame, stream, reduced count,
    alike on every tp card) and held to the reference in float64 over the
    same poses, chunks and rows."""
    hi = Reference(config, device, torch.float64)
    lo = Reference(config, device, dtype)
    step = int(limits["sample"]["row_step"])
    per = []
    for s in samples:
        first = correct.rows_of(seed, s, step)
        tp = int(np.asarray(s["reduced"]).shape[1])
        for view in _views(s):
            want = correct.ref_frame(hi, view, first, step)
            got = correct.ref_frame(lo, view, first, step)
            color = np.zeros((hi.height, hi.width), np.int32)
            depth = np.zeros((hi.height, hi.width), np.float64)
            color[first::step], depth[first::step] = got.color, got.depth
            meshes = {tuple(p): (m, np.bincount((m >> 29) & 7,
                                                minlength=6)[:6])
                      for p, m in zip(got.positions.tolist(), got.meshes)}
            n = bands.reduced_count(bands.stream_of(lo, got, view["pose"]),
                                    tp)
            fake = dict(meshes=meshes, color=color, depth=depth,
                        stats=np.array([got.gathered, n, 0, 0]))
            nums = correct.compare(fake, want, first, step)
            nums.update(count_split=0, band_count_diff=abs(
                n - bands.reduced_count(bands.stream_of(hi, want,
                                                        view["pose"]), tp)))
            per.append(nums)
    return correct.worst(per)


def no_exchange(cell):
    """The band counts left unexchanged: the render's ``reduce`` (each dp
    row's all-reduce and division by tp) does nothing."""
    return faults._swap(cell.eng._views_render(), "reduce",
                        lambda shards: None)


def altered_band(cell):
    """One band altered where it is produced: a 64 x 64 block of the
    colour of the first view's second band, on its card, inverted before
    the gather."""
    render = cell.eng._views_render()
    orig = render.gather

    def gather(shards):
        c = shards[0, render.mesh.tp - 1][0][0]
        h, w = c.shape
        c[h // 2:h // 2 + faults.BLOCK, w // 2:w // 2 + faults.BLOCK] ^= (
            0x00FFFFFF)
        return orig(shards)

    return faults._swap(render, "gather", gather)


FAULTS = {"no_exchange": no_exchange, "altered_band": altered_band}

"""The runner of the one-card cells (``"runner": "engine"``):
``Engine.render_frame`` driven by the traffic's poses in a closed loop
with at most ``outstanding`` frames in flight.

Set-up applies the configuration: its ``render``, ``world`` and
``pool_slots``, the constructor's ``engine_args`` and the attributes
``engine_attrs`` (each one the engine already has); settles the world at
the first pose, meshes every loaded chunk (``prime_all``), captures every
gather bucket's graphs (``warm_buckets``, and ``warm_streaming`` where
the camera moves) and renders the traffic's first ``warmup_frames``
frames.  The window then renders frame after frame from there.

For the comparison it keeps, at each sampled frame, what the engine
shows through its public state: the world's loaded chunks, the pool's
meshed positions and the pooled meshes of the chunks in the pose's view,
and the frame's outputs.  The draw list and the neighbours a mesh saw
are the reference's to work out."""

from __future__ import annotations

import collections
import gc
import time

import numpy as np
import torch

from .. import poses
from ..clock import Clock
from ..reference import funnel
from ..trace import Profile, Spans


def set_pose(camera, pose: poses.Pose) -> None:
    camera.position = np.asarray(pose.position, np.float32)
    camera.yaw = pose.yaw
    camera.pitch = pose.pitch


class Sample(dict):
    """What the comparison reads of one frame (keys as set below)."""


class Runner:
    def __init__(self, cell, seed: int, *, device="cuda",
                 trace: bool = False):
        self.cell, self.seed, self.trace = cell, seed, trace
        self.cfg = cell.config
        self.traffic = poses.Traffic(cell.traffic, seed)
        self.device = torch.device(device)
        self.devices = [self.device]
        self.samples: list = []
        self.setup_info: dict = {}

    # ------------------------------------------------------------- set-up
    def _engine(self):
        """The configuration's engine, its world settled at the traffic's
        first pose and every loaded chunk meshed (``prime_all``)."""
        from differential_projection_voxel_renderer_tpu_torch.app.engine import (  # noqa: E501
            Engine)
        from differential_projection_voxel_renderer_tpu_torch.models.world import (  # noqa: E501
            WorldConfig)
        from differential_projection_voxel_renderer_tpu_torch.utils.config import (  # noqa: E501
            RenderConfig)

        cfg = self.cfg
        if self.trace:
            for d in self.devices:
                warm_profiler(d)
        eng = Engine(render_config=RenderConfig(**cfg["render"]),
                     world_config=WorldConfig(**cfg["world"]),
                     pool_slots=int(cfg["pool_slots"]), device=self.device,
                     **cfg.get("engine_args", {}))
        for attr, value in cfg.get("engine_attrs", {}).items():
            if not hasattr(eng, attr):
                raise AttributeError(f"the engine has no attribute {attr!r}"
                                     " to set")
            setattr(eng, attr, value)
        set_pose(eng.camera, self.traffic.pose(0))
        t = time.perf_counter()
        while eng.world.update(eng.camera.position):
            pass
        eng.prime_all()
        self.setup_info["settle_prime_s"] = time.perf_counter() - t
        return eng

    def setup(self) -> None:
        eng = self.eng = self._engine()
        t = time.perf_counter()
        eng.warm_buckets()
        if self.traffic.moves:
            eng.warm_streaming()
        self.first = self.traffic.warmup
        for i in range(self.first):
            set_pose(eng.camera, self.traffic.pose(i))
            eng.render_frame(dt=self.traffic.dt)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_info["warm_s"] = time.perf_counter() - t

    def wrap_spans(self, spans: Spans) -> None:
        """The traced run's spans: the entry, the world's update and, where
        the engine has it, its meshing call (which counts the chunks it is
        handed that are loaded)."""
        eng = self.eng
        spans.wrap(eng, "render_frame", "entry")
        spans.wrap(eng.world, "update", "world_update")
        if hasattr(eng, "_mesh_list"):
            def n_meshed(to_mesh, defer=False):
                return sum(1 for p in set(to_mesh) if p in eng.world.chunks)

            spans.wrap(eng, "_mesh_list", "meshing", count=n_meshed)

    # ------------------------------------------------------------- window
    def _call(self, k: int):
        """Issue the window's frame ``k`` (the traffic's frame first + k)."""
        set_pose(self.eng.camera, self.traffic.pose(self.first + k))
        return self.eng.render_frame(dt=self.traffic.dt)

    def window(self, seconds: float, trace: bool) -> dict:
        """Frames for ``seconds``, at most ``outstanding`` in flight: a
        frame waits for the completion mark of the frame ``outstanding``
        before it."""
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
        captures0 = _captures()
        host = HostUse()
        t0 = clock.start()
        k = 0
        # a profile once started runs its frames to the end
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
                prof = Profile().__enter__()
            issue.append(time.perf_counter() - t0)
            out = self._call(k)
            marks.append(clock.mark())
            if prof is not None and not profiled:
                stats.append(own(out.stats))
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
            # the stream length of each profiled frame, from its stats
            prof_info = dict(prof.read(), frames=p_frames,
                             gathered=torch.stack(stats)[:, 0].tolist())
        if not any(s["k"] == last[0] for s in self.samples):
            self.samples.append(self._sample(*last))
        done = [clock.seconds(m) for m in marks]
        lat_ms = [(d - s) * 1e3 for d, s in zip(done, issue)]
        return dict(frames=k, window_s=max(done), latencies_ms=lat_ms,
                    captures_in_window=_captures() - captures0,
                    spans=spans, profile=prof_info)

    def _sample(self, k: int, res) -> Sample:
        """The frame's outputs and the engine's public state after its
        call: the loaded chunks, the pooled positions, and the pooled
        meshes of the chunks inside the pose's view sphere and frustum
        (the draw list is among them)."""
        eng, pose = self.eng, self.traffic.pose(self.first + k)
        keys = list(eng.world.chunks)
        r = self.cfg["render"]
        cam = funnel.camera_of(pose.position, pose.yaw, pose.pitch,
                               int(r["width"]), int(r["height"]))
        vis = funnel.visible_positions(
            np.asarray(keys, np.int64).reshape(-1, 3), cam.position,
            cam.extract_frustum(), int(self.cfg["world"]["view_distance"]))
        pool = eng.pool
        pooled = set(pool.by_pos)
        held = [tuple(p) for p in vis.tolist() if tuple(p) in pooled]
        slots = np.array([pool.by_pos[p] for p in held], np.int64)
        idx = torch.from_numpy(slots)
        if self.device.type == "cuda":
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        return Sample(
            k=k, pose=pose, keys=keys, pooled=pooled, held=held,
            counts6=np.array(pool.counts6[slots], np.int64),
            rows=pool.quads.index_select(0, idx),
            color=res.color, depth=res.depth, stats=res.stats)

    def host_samples(self) -> list:
        """The samples with their tensors on the host and each held mesh
        as {position: (uint32 words, counts by direction)}."""
        out = []
        for s in self.samples:
            h = Sample({k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                            else v) for k, v in s.items()})
            rows, c6 = h.pop("rows"), h.pop("counts6")
            h["meshes"] = {p: (rows[j][:int(c6[j].sum())].view(np.uint32),
                               c6[j]) for j, p in enumerate(h.pop("held"))}
            out.append(h)
        return out

    def release(self) -> None:
        """Drop the engine (the samples keep their own tensors)."""
        self.eng = None


class HostUse:
    """The host's share of the window, for the run's log: the process's
    CPU seconds against the wall clock, the times it was made to yield
    its core, and the garbage collector's passes and their time."""

    def __init__(self):
        import resource

        self._r = resource
        self.u0 = resource.getrusage(resource.RUSAGE_SELF)
        self.t0 = time.perf_counter()
        self.gc = collections.Counter()
        self.gc_ms = 0.0
        self._t = None
        gc.callbacks.append(self._on_gc)

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.gc[info["generation"]] += 1
            self.gc_ms += (time.perf_counter() - self._t) * 1e3

    def read(self) -> dict:
        gc.callbacks.remove(self._on_gc)
        u = self._r.getrusage(self._r.RUSAGE_SELF)
        return dict(
            wall_s=time.perf_counter() - self.t0,
            cpu_s=(u.ru_utime - self.u0.ru_utime)
            + (u.ru_stime - self.u0.ru_stime),
            involuntary_switches=u.ru_nivcsw - self.u0.ru_nivcsw,
            gc_passes=dict(sorted(self.gc.items())), gc_ms=self.gc_ms)


def own(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy where it is a view into more memory than its own
    (a frame's stats kept past the frame must not keep its frame)."""
    if t.untyped_storage().nbytes() > t.numel() * t.element_size():
        return t.clone()
    return t


def warm_profiler(device) -> None:
    """Set the profiler up once before any graph is captured: kernels
    replayed from graphs captured before its first window are not traced
    (and the first window's start, CUPTI's set-up, takes seconds)."""
    import os

    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    with Profile():
        torch.ones(8, device=device).sum().item()


def _captures() -> int:
    from differential_projection_voxel_renderer_tpu_torch.rendering import (
        graphs)

    return int(graphs.calls["captures"])

"""The runner of the frames-in-flight cells (``"runner": "inflight"``):
``Engine.render_frame_pipelined`` driven by the traffic's poses in a
closed loop with at most ``outstanding`` calls in flight.  A call enters
its pose's frame and returns the frame entered a call before.

Set-up is ``runners/engine.py``'s (settle, ``prime_all``) with
``warm_buckets(pipelined=True)`` in place of ``warm_buckets()`` (the
frames-in-flight path never takes the serial fused insert, so nothing
warms it), then the traffic's first ``warmup_frames`` frames entered and
drained with ``flush_pipeline``: the window starts with nothing in
flight.

The window: call ``k`` issues pose ``first + k`` and returns frame
``k - 1``; after the last call ``flush_pipeline`` returns the last frame,
and a second flush must return nothing.  Frame ``j`` completes at the
mark of the call that emits it (call ``j + 1``, or the first flush): its
latency is that mark less the issue of call ``j``, the latency a viewer
sees with the frame in flight counted.  ``fps`` counts the frames over
first issue to last completion.

A sample pairs frame ``j``'s outputs, when they come out, with pose ``j``
and the engine's public state at call ``j`` (as ``runners/engine.py``
keeps it).  ``judge`` holds each sampled frame to the reference at its
pose (``correct.py``) and adds ``order_diff``: the emitted frames
missing, doubled or out of order against ``reference/inflight.py``'s
model of the calls, given the gather bucket of each call's frame (read
from the engine's carried frame after the call).  A frame emitted in
another frame's place is seen where it is sampled, by the frame's
numbers.

``FAULTS``: a frame dropped and a frame emitted twice, planted as
``faults.py``'s are (``benchmark/control_views.py`` takes their
readings)."""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from .. import correct, faults, poses
from ..clock import Clock
from ..reference import inflight as model
from ..reference.frame import Reference
from ..trace import Profile, Spans
from . import engine as base

# the outputs of a frame that has not come out yet
_NOT_OUT = types.SimpleNamespace(color=None, depth=None, stats=None)


class Runner(base.Runner):
    def setup(self) -> None:
        eng = self.eng = self._engine()
        t = time.perf_counter()
        eng.warm_buckets(pipelined=True)
        self.first = self.traffic.warmup
        for i in range(self.first):
            base.set_pose(eng.camera, self.traffic.pose(i))
            eng.render_frame_pipelined(dt=self.traffic.dt)
        eng.flush_pipeline()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_info["warm_s"] = time.perf_counter() - t

    def wrap_spans(self, spans: Spans) -> None:
        """``runners/engine.py``'s spans, with the entry the frames-in-flight
        calls: ``render_frame_pipelined`` and ``flush_pipeline``."""
        super().wrap_spans(spans)
        spans.wrap(self.eng, "render_frame_pipelined", "entry")
        spans.wrap(self.eng, "flush_pipeline", "entry")

    def _call(self, k: int):
        """Enter the window's frame ``k`` (the traffic's frame first + k);
        returns frame ``k - 1``'s result, or None."""
        base.set_pose(self.eng.camera, self.traffic.pose(self.first + k))
        return self.eng.render_frame_pipelined(dt=self.traffic.dt)

    def _bucket(self):
        """The gather bucket of the frame entered last (the engine's carried
        frame's), or None where nothing is in flight."""
        carry = getattr(self.eng.renderer, "_pipe_carry", None)
        return None if carry is None else int(carry[0])

    def _state(self, k: int) -> base.Sample:
        """The engine's public state at call ``k``, its frame to come."""
        return self._sample(k, _NOT_OUT)

    def window(self, seconds: float, trace: bool) -> dict:
        """Calls for ``seconds``, at most ``outstanding`` in flight: a call
        waits for the mark of the call ``outstanding`` before it; then the
        flushes (the module's docstring says what is measured)."""
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
        calls = dict(buckets=[], emitted=[], flushed=[])
        pending = {}  # frame: its sample, waiting for the frame's outputs

        def came_out(j, out):
            if out is not None and j in pending:
                s = pending.pop(j)
                s.update(color=out.color, depth=out.depth, stats=out.stats)
                self.samples.append(s)

        captures0 = base._captures()
        host = base.HostUse()
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
            calls["buckets"].append(self._bucket())
            calls["emitted"].append(out is not None)
            if prof is not None and not profiled and out is not None:
                stats.append(base.own(out.stats))
            came_out(k - 1, out)
            if k in sample_at:
                pending[k] = self._state(k)
            if trace and k == p_first + p_frames - 1:
                clock.wait(marks[-1])
                prof.__exit__(None, None, None)
                profiled = spans.active = True
            if trace and spans.active:
                spans.frames += 1
            k += 1
        # the last frame comes out at the first flush; the second finds
        # nothing in flight
        if k - 1 not in pending:
            pending[k - 1] = self._state(k - 1)
        for j in range(2):
            out = self.eng.flush_pipeline()
            if not j:
                marks.append(clock.mark())
                came_out(k - 1, out)
            calls["flushed"].append(out is not None)
            if trace and spans.active:
                spans.frames += 1
        clock.finish()
        self.calls = calls
        self.setup_info["window_host"] = dict(
            host.read(),
            drains_by_model=len(model.emissions(calls["buckets"])[2]))
        prof_info = {}
        if profiled:
            # the stream length of each profiled frame that came out, from
            # its stats
            prof_info = dict(prof.read(), frames=p_frames,
                             gathered=torch.stack(stats)[:, 0].tolist())
        done = [clock.seconds(m) for m in marks]
        lat_ms = [(done[j + 1] - issue[j]) * 1e3 for j in range(k)]
        return dict(frames=k, window_s=max(done), latencies_ms=lat_ms,
                    captures_in_window=base._captures() - captures0,
                    spans=spans, profile=prof_info)

    def host_samples(self) -> list:
        """``runners/engine.py``'s samples, each also holding the window's
        record of its calls (``calls``: each call's bucket and whether it
        emitted a frame, whether each flush did)."""
        out = super().host_samples()
        for s in out:
            s["calls"] = self.calls
        return out


def judge(config: dict, samples: list, seed: int, limits: dict, device,
          dtype=torch.float64) -> tuple[bool, dict]:
    """(correct, {number: (value, limit)}): ``correct.py``'s numbers over
    the sampled frames, each at its own pose, and ``order_diff`` over the
    window's calls (the module's docstring)."""
    ref = Reference(config, device, dtype)
    step = int(limits["sample"]["row_step"])
    per = []
    for s in samples:
        first = correct.rows_of(seed, s, step)
        per.append(correct.compare(s, correct.ref_frame(ref, s, first, step),
                                   first, step))
        correct._log(s["k"], np.asarray(s["stats"]).tolist(), per[-1])
    got = correct.worst(per)
    c = samples[0]["calls"]
    got["order_diff"] = model.order_diff(c["buckets"], c["emitted"],
                                         c["flushed"])
    lim = limits["limits"]
    table = {k: (got[k], lim[k]) for k in lim}
    return all(v <= m for v, m in table.values()), table


def control(config: dict, samples: list, seed: int, limits: dict, device,
            dtype=torch.bfloat16) -> dict:
    """``correct.control``'s numbers over the same frames, and
    ``order_diff`` 0: the reference put in the program's place emits each
    frame where the model does."""
    return dict(correct.control(config, samples, seed, limits, device,
                                dtype), order_diff=0)


def dropped_frame(cell):
    """A frame lost: the first frame that comes out after the fault is
    planted, of a call or of a flush, comes out as nothing."""
    lost = []

    def dropping(orig):
        def call(*a, **kw):
            res = orig(*a, **kw)
            if res is None or lost:
                return res
            lost.append(res)
            return None

        return call

    eng = cell.eng
    undo = [faults._swap(eng, name, dropping(getattr(eng, name)))
            for name in ("render_frame_pipelined", "flush_pipeline")]
    return lambda: [u() for u in undo[::-1]]


def doubled_frame(cell):
    """A frame emitted twice: a flush that finds nothing in flight returns
    the frame the flush before it emitted."""
    orig = cell.eng.flush_pipeline
    last = []

    def flush_pipeline(*a, **kw):
        res = orig(*a, **kw)
        if res is None:
            return last.pop() if last else None
        last[:] = [res]
        return res

    return faults._swap(cell.eng, "flush_pipeline", flush_pipeline)


FAULTS = {"dropped_frame": dropped_frame, "doubled_frame": doubled_frame}

"""The traced run's readings: host spans from wrappers the harness puts on
the instance (never on the program's modules), and a ``torch.profiler``
window over a steady run of frames inside the measured window.

Spans (``bench:<name>``, host clock, and a ``record_function`` of that
name so that the profiler's timeline shows them):

- ``entry``: ``Engine.render_frame``, the entry the window drives;
- ``world_update``: the world's public ``update``;
- ``meshing``: the engine's meshing call (``Engine._mesh_list``, where
  the engine has one), which also counts the chunks it meshes;
- ``wait``: the loop waiting for the oldest outstanding frame.

Span sums leave out the profiled frames, which the profiler slows."""

from __future__ import annotations

import collections
import time

import torch

from . import timing

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SPAN_PREFIX = "bench:"


class Spans:
    def __init__(self):
        self.ms = collections.Counter()
        self.calls = collections.Counter()
        self.counts = collections.Counter()
        self.frames = 0          # frames whose spans are summed
        self.active = True

    def span(self, name: str):
        return _Span(self, name)

    def wrap(self, obj, attr: str, name: str, count=None) -> None:
        """Wrap ``obj.attr`` (an instance attribute shadows the method):
        its host time goes to span ``name``; ``count(*args)`` adds to the
        counter ``name``."""
        orig = getattr(obj, attr)

        def wrapper(*args, **kw):
            if count is not None and self.active:
                self.counts[name] += count(*args, **kw)
            with self.span(name):
                return orig(*args, **kw)

        setattr(obj, attr, wrapper)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name
        self.rf = torch.profiler.record_function(SPAN_PREFIX + name)

    def __enter__(self):
        self.rf.__enter__()
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t
        self.rf.__exit__(*exc)
        if self.spans.active:
            self.spans.ms[self.name] += dt * 1e3
            self.spans.calls[self.name] += 1


class Profile:
    """A torch.profiler window; ``read()`` reduces it."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)

    def read(self) -> dict:
        """{"busy_us": {device: us}, "window_us", "kernels": {name: us},
        "launches",
        "gaps": [(us, span)] of the busiest device, longest first}."""
        from torch.autograd import DeviceType

        events = self.prof.events()
        # the harness's spans show on the device timeline too, as user
        # annotations: they are not device work
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(SPAN_PREFIX)]
        host = [e for e in events if e.device_type != DeviceType.CUDA]
        if not events:
            return {}
        start = min(e.time_range.start for e in events)
        end = max(e.time_range.end for e in events)
        by_dev = collections.defaultdict(list)
        kernels = collections.Counter()
        for e in dev:
            by_dev[e.device_index].append((e.time_range.start,
                                           e.time_range.end))
            us = e.time_range.end - e.time_range.start
            kernels[e.name] += us
        busy, merged = {}, {}
        for d, spans in by_dev.items():
            busy[d], merged[d] = timing.busy_intervals(spans)
        launches = sum(1 for e in host if e.name in LAUNCH_CALLS)
        gaps = []
        if busy:
            top = max(busy, key=busy.get)
            spans = sorted((e.time_range.start, e.time_range.end,
                            e.name[len(SPAN_PREFIX):]) for e in host
                           if e.name.startswith(SPAN_PREFIX))
            for a, b in timing.idle_gaps(merged[top], start, end):
                gaps.append((b - a, _span_at(spans, (a + b) / 2)))
            gaps.sort(reverse=True)
        return dict(busy_us=busy, window_us=end - start,
                    kernels=dict(kernels),
                    launches=launches, gaps=gaps)


def _span_at(spans, t: float) -> str:
    """The innermost harness span open at ``t`` (the latest to start)."""
    name = "other"
    for a, b, n in spans:
        if a > t:
            break
        if b >= t:
            name = n
    return name


def breakdown(prof: dict) -> dict:
    """The result line's ``breakdown``: the 10 device operations that took
    the most time and the 10 longest idle gaps by the span the host was
    in, in seconds over the profiled frames."""
    ops = sorted(prof.get("kernels", {}).items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:120], us / 1e6] for n, us in ops[:10]],
            "idle_gaps": [[n, us / 1e6] for us, n in prof.get("gaps",
                                                               [])[:10]]}

"""Perf / observability: timers, stage stats, function counters, and
torch.profiler integration.

The port's copy of ``differential_projection_voxel_renderer_tpu/utils/
profiling.py``, as it is but for ``trace``, there a ``jax.profiler`` scope
and here a ``torch.profiler`` one.

Reference: src/perf/ — three tiers (SURVEY.md section 5 "Tracing"):
1. RAII wall-clock PerfTimer / perf_scope! printing on drop
   (perf/mod.rs:9-34, 86-91)           -> PerfTimer / perf_scope here
2. global relaxed-atomic FunctionCounters compiled in only with
   --features profiling (perf/profiling.rs:6-47, 147-154)
                                        -> FunctionCounters (plain ints —
                                           host code is single-threaded;
                                           device-side funnel counters come
                                           back in the render step's stats
                                           vector instead of atomics)
3. Linux perf-event hardware counters (perf/profiling.rs:169-278)
                                        -> PerfCounters: the same CPU
                                           counters via a ctypes
                                           perf_event_open wrapper (host-
                                           side code: meshing, culling,
                                           binning prep); trace(): a
                                           torch.profiler trace is the
                                           device-side equivalent (view in
                                           TensorBoard or Perfetto)
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field


class PerfTimer:
    """Wall-clock scope timer printing microseconds on exit
    (perf/mod.rs:9-34)."""

    def __init__(self, name: str, *, quiet: bool = False):
        self.name = name
        self.quiet = quiet
        self.elapsed_us: float | None = None
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self.elapsed_us = (time.perf_counter() - self._t0) * 1e6
        if not self.quiet:
            print(f"[perf] {self.name}: {self.elapsed_us:.1f}us")
        return self.elapsed_us

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


@contextlib.contextmanager
def perf_scope(name: str):
    """perf_scope! macro analogue (perf/mod.rs:86-91)."""
    t = PerfTimer(name)
    try:
        yield t
    finally:
        t.stop()


@dataclass
class PerfStats:
    """Accumulating stage summary (perf/mod.rs:37-82)."""

    stages: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    def record(self, stage: str, seconds: float) -> None:
        self.stages[stage] = self.stages.get(stage, 0.0) + seconds
        self.counts[stage] = self.counts.get(stage, 0) + 1

    @contextlib.contextmanager
    def scope(self, stage: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(stage, time.perf_counter() - t0)

    def report(self) -> str:
        lines = ["=== perf stats ==="]
        for stage, total in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            n = self.counts[stage]
            lines.append(
                f"{stage}: total {total*1e3:.2f}ms, {n} calls, "
                f"avg {total/n*1e6:.1f}us"
            )
        return "\n".join(lines)


# Counter taxonomy mirrors FunctionCounters (perf/profiling.rs:6-47); the
# device-side members (pixels tested/passed) live in the render step's
# stats vector and are folded in by the engine when profiling is on.
_COUNTER_NAMES = (
    "mesh_chunk_calls",
    "greedy_mesh_slice_calls",
    "generate_binary_masks_calls",
    "quads_gathered",
    "quads_rasterized",
    "quads_culled",
    "render_frames",
    "chunks_horizon_culled",
    "chunks_occlusion_culled",
)

_ENABLED = bool(os.environ.get("DPVR_PROFILING"))


class FunctionCounters:
    """Global counters, a no-op unless DPVR_PROFILING is set — mirroring the
    reference's zero-cost-unless-enabled contract (profiling.rs:147-154)."""

    def __init__(self):
        self.enabled = _ENABLED
        self._c = {k: 0 for k in _COUNTER_NAMES}

    def add(self, name: str, n: int = 1) -> None:
        if self.enabled:
            self._c[name] = self._c.get(name, 0) + int(n)

    def snapshot(self) -> dict[str, int]:
        return dict(self._c)

    def reset(self) -> None:
        for k in self._c:
            self._c[k] = 0

    def report(self) -> str:
        snap = self.snapshot()
        lines = ["=== function counters ==="]
        for k, v in snap.items():
            lines.append(f"{k}: {v}")
        return "\n".join(lines)


FUNCTION_COUNTERS = FunctionCounters()


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler trace scope, the port's form of the reference's
    ``jax.profiler`` scope: host ops and, when a card is present, its
    kernels.  On exit one Chrome-format ``*.pt.trace.json`` lands in
    ``log_dir`` (by default ``dpvr_trace`` under the temporary directory);
    open it in TensorBoard's profiler plugin or in Perfetto for per-kernel
    timing."""
    import tempfile

    import torch

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "dpvr_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield log_dir


# ---------------------------------------------------------------------------
# Hardware counters (Linux perf_event) — perf/profiling.rs:169-278
# ---------------------------------------------------------------------------

_PERF_TYPE_HARDWARE = 0
_HW_EVENTS = {  # perf_event.h PERF_COUNT_HW_*
    "cycles": 0,
    "instructions": 1,
    "cache_references": 2,
    "cache_misses": 3,
    "branches": 4,
    "branch_misses": 5,
}


class PerfCounters:
    """CPU hardware counters for the host-side stages (meshing, culling,
    gather-index prep) via the raw ``perf_event_open`` syscall — the
    reference's `perf-event` crate wrapper (profiling.rs:169-278): cycles,
    instructions, cache refs/misses, branches/misses, with an IPC /
    hit-rate report.  Degrades gracefully (``available`` False) where the
    kernel forbids it (containers, perf_event_paranoid)."""

    def __init__(self, events=("cycles", "instructions",
                               "cache_references", "cache_misses",
                               "branches", "branch_misses")):
        import ctypes
        import platform
        import struct

        self._fds: dict[str, int] = {}
        self._os = os
        self.available = False
        if platform.system() != "Linux":
            return
        libc = ctypes.CDLL(None, use_errno=True)
        # struct perf_event_attr (only the leading fields matter; the rest
        # is zeroed; size = PERF_ATTR_SIZE_VER0 = 64)
        for name in events:
            config = _HW_EVENTS[name]
            attr = struct.pack(
                "IIQQQQQ",
                _PERF_TYPE_HARDWARE,   # type
                128,                   # size (PERF_ATTR_SIZE_VER3 incl.
                                       # the flags word we need)
                config,                # config
                0,                     # sample_period
                0,                     # sample_type
                0,                     # read_format
                1 << 0 | 1 << 5,       # flags: disabled | exclude_kernel
            )
            attr = attr + b"\x00" * (128 - len(attr))
            buf = ctypes.create_string_buffer(attr, 128)
            fd = libc.syscall(298,  # __NR_perf_event_open (x86_64)
                              buf, 0, -1, -1, 0)
            if fd < 0:
                continue
            self._fds[name] = fd
        self.available = bool(self._fds)

    def enable(self):
        import fcntl
        for fd in self._fds.values():
            fcntl.ioctl(fd, 0x2401, 0)  # PERF_EVENT_IOC_RESET
            fcntl.ioctl(fd, 0x2400, 0)  # PERF_EVENT_IOC_ENABLE

    def disable(self):
        import fcntl
        for fd in self._fds.values():
            fcntl.ioctl(fd, 0x2402, 0)  # PERF_EVENT_IOC_DISABLE

    def read(self) -> dict[str, int]:
        out = {}
        for name, fd in self._fds.items():
            data = self._os.read(fd, 8)
            out[name] = int.from_bytes(data, "little")
        return out

    def report(self) -> str:
        """IPC + cache/branch hit-rate summary (profiling.rs:236-278)."""
        c = self.read()
        lines = [f"{k}: {v:,}" for k, v in c.items()]
        if c.get("cycles") and c.get("instructions"):
            lines.append(f"IPC: {c['instructions'] / c['cycles']:.2f}")
        if c.get("cache_references"):
            hr = 1.0 - c.get("cache_misses", 0) / c["cache_references"]
            lines.append(f"cache hit rate: {hr:.1%}")
        if c.get("branches"):
            hr = 1.0 - c.get("branch_misses", 0) / c["branches"]
            lines.append(f"branch hit rate: {hr:.1%}")
        return "\n".join(lines)

    def close(self):
        for fd in self._fds.values():
            self._os.close(fd)
        self._fds.clear()
        self.available = False

    def __enter__(self):
        self.enable()
        return self

    def __exit__(self, *exc):
        self.disable()
        return False

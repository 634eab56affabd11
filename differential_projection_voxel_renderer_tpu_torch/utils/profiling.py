"""The port's tracer of the frame path, and a ``torch.profiler`` scope.

``TRACER`` records every frame the engine renders: host spans at the
frame path's layer boundaries, counters, and on the card the card's idle
time between them, on the card's own clock.  It is on unless
``DPVR_TRACE=0`` is set when this module is imported; then every span,
marker and counter below is one shared no-op and nothing is recorded.

Spans.  Each span is a preallocated context manager with a fixed id
(``SPAN_NAMES``).  Entering one writes its id and ``time.perf_counter_ns``
into the next two entries of a preallocated ring; leaving it writes -1 and
the time.  ``FRAME(device)`` opens a frame: it numbers it, notes where its
entries start and flags it when a ``torch.profiler`` window is active
(the profiler slows the host, so readers leave such frames out).  Reading
a frame replays its entries: each span's time, calls, first start and
last end, and its parent, the span open around it, whose children's time
it adds to, so that a span's self time is its time less its children's.
The frame path runs on one thread: spans of other threads would tangle.
``PARENT`` is the tree the spans form on the serial path:

    frame
      funnel             Engine._funnel (the resident frame's host part)
        world_update     World.update
          world_queue    the rebuild of the missing-chunk queue
          world_generate chunk generation (counter chunks_generated)
          world_unload   the unload past the view distance + 2
        meshing          Engine._mesh_list and below (counter
                         chunks_meshed: each loaded chunk meshed)
      dispatch           the frame's renderer call
        prepare          draw-list, camera and payload packing; the
                         expansion of Renderer.prepare_uploads
        load             graphs.CapturedCall.load of the frame's inputs
        replay           the graph's replay (on the CPU: its function)
        copy_out         the clone of its outputs

Counters: ``CHUNKS_MESHED.add(n)`` and ``CHUNKS_GENERATED.add(n)`` add to
the open frame's count; they read no device tensor.

The card's clock.  In every ``MARK_EVERY``-th frame on a CUDA device
(a timing event costs the host 3-7 us to record or read on the card's
machine; the sample keeps the tracer's cost a frame small) the tracer
records a timing event, from a ring of ``EVENT_SLOTS`` frames, on the
frame's stream: at the frame's start, at the dispatch's start, just
before the first enqueue of the dispatch and of any other section that
enqueues device work (``mark_enqueue``; ``ENQUEUE`` brackets an eager
section and marks its end too), and at the frame's end, after the
outputs are copied; the frame before it records its end marker alone.
An interval between two markers in which the program enqueued nothing is
time the card was idle while the host was in that interval's span:
``elapsed_time`` between the two events, both on the card's clock, so
nothing compares the card's clock with the host's and nothing waits.
The events are resolved a few sampled frames later with ``query()``.
Each sampled frame keeps three numbers, in ``IDLE_NAMES`` order: the
card idle in all (counted from the previous frame's end marker, so it
includes the time between frames), while the host was in the funnel, and
while the host was in the dispatch before its first enqueue.  A frame not
sampled, or whose events have not run when it is read, reads NaN
(unresolved), never 0.  Idle time inside an interval that enqueued work
is not seen.  ``completed`` counts the frames known to have run on the
card (every frame on the CPU).

``TRACER.frames(last)`` gives the last ``last`` frames held, less the
flagged ones, as arrays.  The tracer outlives any engine.

``trace(log_dir)``: a ``torch.profiler`` scope that writes a Chrome trace
(the JAX package's ``jax.profiler`` scope there).
"""

from __future__ import annotations

import collections
import contextlib
import math
import os
import time

import numpy as np
import torch

ENABLED = os.environ.get("DPVR_TRACE", "1") != "0"

SPAN_NAMES = ("frame", "funnel", "world_update", "world_queue",
              "world_generate", "world_unload", "meshing", "dispatch",
              "prepare", "load", "replay", "copy_out")
PARENT = {"frame": None, "funnel": "frame", "world_update": "funnel",
          "world_queue": "world_update", "world_generate": "world_update",
          "world_unload": "world_update", "meshing": "funnel",
          "dispatch": "frame", "prepare": "dispatch", "load": "dispatch",
          "replay": "dispatch", "copy_out": "dispatch"}
COUNTER_NAMES = ("chunks_meshed", "chunks_generated")
IDLE_NAMES = ("idle", "idle_funnel", "idle_dispatch")

HOLD = 1 << 15          # frames held
LOG = 1 << 21           # ring entries for the spans (two an entry or exit)
MARK_EVERY = 16         # one frame in this many records its markers
EVENT_SLOTS = 16        # sampled frames' events in the ring
MARKERS = 8             # markers a sampled frame at most, its end included
LAG = 1                 # sampled frames left pending at a resolve
_MASK = LOG - 1
_NS, _NC = len(SPAN_NAMES), len(COUNTER_NAMES)
_now = time.perf_counter_ns

# what the host did in the interval that ends at a marker
OUTSIDE, IN_FUNNEL, IN_DISPATCH, IN_FRAME, WORK = range(5)


class Frames:
    """Frames read from the tracer, oldest first: ``number`` int64[n];
    ``ns``, ``child_ns``, ``calls``, ``start_ns``, ``end_ns`` int64[n,
    spans] (a span's first start and last end, 0 where it did not run);
    ``counts`` int64[n, counters]; ``idle_ms`` float64[n, 3]
    (``IDLE_NAMES``, NaN where unresolved or not on a card)."""

    def __init__(self, number, ns, child_ns, calls, start_ns, end_ns,
                 counts, idle_ms):
        self.number, self.ns, self.child_ns = number, ns, child_ns
        self.calls, self.start_ns, self.end_ns = calls, start_ns, end_ns
        self.counts, self.idle_ms = counts, idle_ms

    def __len__(self) -> int:
        return len(self.number)

    def span_ns(self, name: str, self_time: bool = False) -> np.ndarray:
        """Each frame's ns in span ``name`` (less its children's)."""
        j = SPAN_NAMES.index(name)
        out = self.ns[:, j]
        return out - self.child_ns[:, j] if self_time else out

    def count(self, name: str) -> np.ndarray:
        return self.counts[:, COUNTER_NAMES.index(name)]

    def idle(self, name: str) -> np.ndarray:
        return self.idle_ms[:, IDLE_NAMES.index(name)]


class Tracer:
    """The frames' spans, counters and card idle times (module docstring).
    One instance, ``TRACER``; ``reset()`` empties it."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.reset()

    def reset(self) -> None:
        """Forget every frame; the ring and the timing events are made
        again at their first use."""
        self.log = None
        self.pos = 0                     # ring entries written, ever
        self.counts = [0] * ((HOLD + 1) * _NC)
        self.cbase = HOLD * _NC          # the open frame's counters
        self.first = [-1] * HOLD         # a frame's first ring entry
        self.last = [-1] * HOLD          # one past its last, once it ends
        self.number = [-1] * HOLD
        self.flagged = bytearray(HOLD)
        self.idle = [math.nan] * (3 * HOLD)
        self.n = 0                       # frames opened
        self.completed = 0               # frames whose end has run
        self.frame_t0 = 0
        self.last_frame_ns = 0           # the last frame span's host time
        self.in_frame = False
        self.nested = 0
        self._cache = None
        # the card's clock: a slot of events a sampled frame, the frame
        # before it's end marker last
        self.events = None               # EVENT_SLOTS * (MARKERS + 1)
        self.labels = bytearray(EVENT_SLOTS * (MARKERS + 1))
        self.nmk = [0] * EVENT_SLOTS
        self.has_prev = [False] * EVENT_SLOTS
        self.pending: collections.deque = collections.deque()  # groups
        self.device = None               # the open frame's
        self.streams: dict = {}          # card index: its current stream
        self.on_card = False
        self.stream = None               # a sampled open frame's stream
        self.prev_end = None             # (frame, stream) of the last
        self.idle_open = False
        self.phase = IN_FRAME

    def ring(self) -> list:
        """The span ring, made at its first use."""
        if self.log is None:
            self.log = [0] * LOG
        return self.log

    # ----------------------------------------------------------- frames
    def begin_frame(self, device) -> None:
        if self.in_frame:
            self.nested += 1
            return
        f = self.n
        self.n = f + 1
        slot = f % HOLD
        c = self.cbase = slot * _NC
        self.counts[c:c + _NC] = _ZERO_COUNTS
        self.number[slot] = f
        self.flagged[slot] = torch.autograd.profiler._is_profiler_enabled
        self.idle[3 * slot:3 * slot + 3] = _NAN3
        self.in_frame = True
        self.phase = IN_FUNNEL
        self.device = device
        self.on_card = device.type == "cuda"
        if self.on_card and not f % MARK_EVERY:
            self._begin_markers(f, device)
        log = self.log or self.ring()
        p = self.pos
        self.first[slot] = p
        self.last[slot] = -1
        j = p & _MASK
        log[j] = 0
        log[j + 1] = self.frame_t0 = _now()
        self.pos = p + 2

    def end_frame(self) -> None:
        if self.nested:
            self.nested -= 1
            return
        if self.stream is not None:
            self._mark(WORK if not self.idle_open else self.phase, True)
        elif self.on_card and not self.n % MARK_EVERY:
            self._end_before_sampled()
        t = _now()
        p = self.pos
        j = p & _MASK
        self.log[j] = -1
        self.log[j + 1] = t
        self.pos = p + 2
        self.last[(self.n - 1) % HOLD] = p + 2
        self.last_frame_ns = t - self.frame_t0
        self.in_frame = False
        self.cbase = HOLD * _NC
        if self.stream is not None:
            self.stream = None
            self.idle_open = False
            self.resolve(LAG)
        elif not self.on_card:
            self.completed += 1          # done with its call

    def dispatch_start(self) -> None:
        if self.stream is not None:
            self._mark(self.phase if self.idle_open else WORK)
            self.idle_open = True
        self.phase = IN_DISPATCH

    def dispatch_end(self) -> None:
        # an enqueue the dispatch did not mark would make its interval
        # read as idle: what follows counts as work until the next mark
        self.idle_open = False
        self.phase = IN_FRAME

    # ------------------------------------------------- the card's clock
    def _slot(self, g: int) -> int:
        """Group ``g``'s (sampled frame ``g * MARK_EVERY``'s) event slot;
        a pending group that held it is resolved now if its events have
        run, else left unresolved."""
        if self.events is None:
            self.events = [torch.cuda.Event(enable_timing=True) for _ in
                           range(EVENT_SLOTS * (MARKERS + 1))]
        while self.pending and self.pending[0] <= g - EVENT_SLOTS:
            self._resolve_one(self.pending.popleft())
        return g % EVENT_SLOTS

    def _stream(self, device):
        """``device``'s current stream: the object kept for it while the
        current stream's handle is its (``torch.cuda.current_stream``
        costs 6-10 us there)."""
        i = (device.index if device.index is not None
             else torch.cuda.current_device())
        s = self.streams.get(i)
        if s is None or s.cuda_stream != torch._C._cuda_getCurrentRawStream(
                i):
            s = self.streams[i] = torch.cuda.current_stream(i)
        return s

    def _end_before_sampled(self) -> None:
        """The end marker of the frame before a sampled one."""
        s = self._slot(self.n // MARK_EVERY)
        stream = self._stream(self.device)
        self.events[s * (MARKERS + 1) + MARKERS].record(stream)
        self.prev_end = (self.n - 1, stream)

    def _begin_markers(self, f: int, device) -> None:
        s = self._slot(f // MARK_EVERY)
        stream = self._stream(device)
        self.has_prev[s] = self.prev_end == (f - 1, stream)
        self.nmk[s] = 0
        self.stream = stream
        self._mark(OUTSIDE)
        self.idle_open = True

    def _mark(self, label: int, end: bool = False) -> None:
        """Record a marker closing an interval of kind ``label``; the
        frame's last free marker is kept for its end."""
        g = (self.n - 1) // MARK_EVERY
        s = g % EVENT_SLOTS
        k = self.nmk[s]
        if k >= MARKERS - 1 and not end:
            self.idle_open = False
            return
        i = s * (MARKERS + 1) + k
        self.events[i].record(self.stream)
        self.labels[i] = label
        self.nmk[s] = k + 1
        if end:
            self.pending.append(g)

    def mark_enqueue(self) -> None:
        """Just before the program enqueues device work in a frame."""
        if self.idle_open:
            self._mark(self.phase)
            self.idle_open = False

    def enqueued(self) -> None:
        """After an eager section's last enqueue: the card's idle is
        measured again from here."""
        if self.stream is not None:
            self._mark(WORK)
            self.idle_open = True

    def resolve(self, lag: int = 0) -> None:
        """Resolve the pending sampled frames whose events have run,
        oldest first, leaving ``lag`` of them; never waits."""
        while len(self.pending) > lag and self._resolve_one(
                self.pending[0]):
            self.pending.popleft()

    def _resolve_one(self, g: int) -> bool:
        s = g % EVENT_SLOTS
        k = self.nmk[s]
        base = s * (MARKERS + 1)
        evs = self.events[base:base + k]
        if not evs[-1].query():
            return False
        labels = self.labels[base:base + k]
        funnel = dispatch = other = 0.0
        for i in range(1, k):
            lab = labels[i]
            if lab == WORK:
                continue
            ms = evs[i - 1].elapsed_time(evs[i])
            if lab == IN_FUNNEL:
                funnel += ms
            elif lab == IN_DISPATCH:
                dispatch += ms
            else:
                other += ms
        total = math.nan
        if self.has_prev[s]:
            total = (self.events[base + MARKERS].elapsed_time(evs[0])
                     + funnel + dispatch + other)
        f = g * MARK_EVERY
        slot = f % HOLD
        if self.number[slot] == f:
            self.idle[3 * slot:3 * slot + 3] = [total, funnel, dispatch]
        self.completed = max(self.completed, f + 1)
        return True

    # ---------------------------------------------------------- reading
    def frames(self, last: int) -> Frames:
        """The last ``last`` frames held (at most ``HOLD``; a frame whose
        ring entries were written over is not held) less those recorded
        under a ``torch.profiler`` window, oldest first, with every frame
        whose events have run resolved."""
        self.resolve()
        key = (self.n, self.completed, self.pos, int(last))
        if self._cache is not None and self._cache[0] == key:
            return self._cache[1]
        done = self.n - self.in_frame
        nums = [f for f in range(done - min(int(last), HOLD, done), done)
                if not self.flagged[f % HOLD]
                and self.pos - self.first[f % HOLD] <= LOG]
        spans = np.zeros((5, len(nums), _NS), np.int64)
        for r, f in enumerate(nums):
            self._replay(f % HOLD, spans[:, r])
        slots = np.asarray(nums, np.int64) % HOLD
        counts = np.asarray(self.counts[:HOLD * _NC], np.int64).reshape(
            HOLD, _NC)[slots]
        idle = np.asarray(self.idle, np.float64).reshape(HOLD, 3)[slots]
        out = Frames(np.asarray(nums, np.int64), *spans, counts, idle)
        self._cache = (key, out)
        return out

    def _replay(self, slot: int, out: np.ndarray) -> None:
        """One frame's ring entries into ``out`` [5, spans]: time,
        children's time, calls, first start, last end."""
        log = self.log
        ns, child, calls, t0, t1 = ([0] * _NS for _ in range(5))
        stack = []
        for p in range(self.first[slot], self.last[slot], 2):
            sid, t = log[p & _MASK], log[(p + 1) & _MASK]
            if sid >= 0:
                stack.append((sid, t))
                continue
            sid, s = stack.pop()
            dt = t - s
            ns[sid] += dt
            if not calls[sid]:
                t0[sid] = s
            calls[sid] += 1
            t1[sid] = t
            if stack:
                child[stack[-1][0]] += dt
        out[:] = (ns, child, calls, t0, t1)


_ZERO_COUNTS = [0] * _NC
_NAN3 = [math.nan] * 3
TRACER = Tracer(ENABLED)


class _Span:
    __slots__ = ("sid",)

    def __init__(self, sid: int):
        self.sid = sid

    def __enter__(self):
        tr = TRACER
        p = tr.pos
        j = p & _MASK
        log = tr.log or tr.ring()
        log[j] = self.sid
        log[j + 1] = _now()
        tr.pos = p + 2

    def __exit__(self, *exc):
        t = _now()
        tr = TRACER
        p = tr.pos
        j = p & _MASK
        log = tr.log
        log[j] = -1
        log[j + 1] = t
        tr.pos = p + 2


class _Frame:
    """``with FRAME(device):`` a frame (a nested one adds nothing)."""

    __slots__ = ("device",)

    def __call__(self, device):
        self.device = device
        return self

    def __enter__(self):
        TRACER.begin_frame(self.device)

    def __exit__(self, *exc):
        TRACER.end_frame()


class _Dispatch(_Span):
    __slots__ = ()

    def __enter__(self):
        TRACER.dispatch_start()
        _Span.__enter__(self)

    def __exit__(self, *exc):
        _Span.__exit__(self)
        TRACER.dispatch_end()


class _Enqueue:
    """An eager section that enqueues device work: its first enqueue and
    its end are marked (an inner section adds nothing)."""

    __slots__ = ("depth",)

    def __init__(self):
        self.depth = 0

    def __enter__(self):
        self.depth += 1
        TRACER.mark_enqueue()

    def __exit__(self, *exc):
        self.depth -= 1
        if not self.depth:
            TRACER.enqueued()


class _Counter:
    __slots__ = ("cid",)

    def __init__(self, cid: int):
        self.cid = cid

    def add(self, n: int) -> None:
        tr = TRACER
        tr.counts[tr.cbase + self.cid] += n


class _Noop:
    """Every span, marker and counter when tracing is off."""

    __slots__ = ()

    def __call__(self, *a):
        return self

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None

    def add(self, n: int) -> None:
        return None


NOOP = _Noop()
if ENABLED:
    (_FRAME_ID, FUNNEL, WORLD_UPDATE, WORLD_QUEUE, WORLD_GENERATE,
     WORLD_UNLOAD, MESHING, _DISPATCH_ID, PREPARE, LOAD, REPLAY,
     COPY_OUT) = (_Span(i) for i in range(_NS))
    FRAME = _Frame()
    DISPATCH = _Dispatch(SPAN_NAMES.index("dispatch"))
    ENQUEUE = _Enqueue()
    CHUNKS_MESHED, CHUNKS_GENERATED = _Counter(0), _Counter(1)
    mark_enqueue = TRACER.mark_enqueue
else:
    (FRAME, FUNNEL, WORLD_UPDATE, WORLD_QUEUE, WORLD_GENERATE, WORLD_UNLOAD,
     MESHING, DISPATCH, PREPARE, LOAD, REPLAY, COPY_OUT, ENQUEUE,
     CHUNKS_MESHED, CHUNKS_GENERATED, mark_enqueue) = (NOOP,) * 16


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """torch.profiler trace scope, the port's form of the reference's
    ``jax.profiler`` scope: host ops and, when a card is present, its
    kernels.  On exit one Chrome-format ``*.pt.trace.json`` lands in
    ``log_dir`` (by default ``dpvr_trace`` under the temporary directory);
    open it in TensorBoard's profiler plugin or in Perfetto for per-kernel
    timing."""
    import tempfile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "dpvr_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                log_dir)):
        yield log_dir

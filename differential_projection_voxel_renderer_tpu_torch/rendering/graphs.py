"""Calls served from CUDA graphs: the port's form of the JAX package's
per-bucket jitted entry points, which run a frame as one dispatch.

``CapturedCall`` holds one function's graph on one device.  Its callers:
the ``Renderer``'s serial entry points (rendering/pipeline.py, one graph
an entry point and gather bucket), ``make_repeated_step`` and the sharded
render's shards (parallel/sharded_render.py).

A kernel wrapper counts a launch when its Python runs: at an eager call
and while a capture records it, never at a replay.  So a capture counts
into its own tally (``_build.counting_into``), which ``run`` adds to the
registry at each replay: every run, eager or replayed, counts the
launches of one eager call of the function.  ``calls`` counts the
captures and the replays, so that a check can tell a replay from a call
that captured again.
"""

from __future__ import annotations

import collections
import gc
import operator
import os

import numpy as np
import torch

from .. import _build
from ..utils import profiling

# captures and replays of every CapturedCall, changed under
# _build.COUNT_LOCK
calls: collections.Counter = collections.Counter()


def _count_call(kind: str) -> None:
    with _build.COUNT_LOCK:
        calls[kind] += 1


def _map(fn, x):
    """``fn`` on every tensor of nested tuples and lists."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    return x


def _copy_out(out):
    return _map(torch.clone, out)


def _spec(x) -> tuple:
    """(shape, dtype) of an input: a tensor, a numpy array, or an integer
    (an int32 scalar)."""
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if isinstance(x, np.ndarray):
        return x.shape, torch.from_numpy(np.empty(0, x.dtype)).dtype
    operator.index(x)
    return (), torch.int32


def _signature(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


def _same(a, b) -> bool:
    """``b`` is the input ``a`` was: the same tensor or array object, or an
    equal integer."""
    if isinstance(a, (torch.Tensor, np.ndarray)) or isinstance(
            b, (torch.Tensor, np.ndarray)):
        return a is b
    return a is not None and operator.index(a) == operator.index(b)


class CapturedCall:
    """``fn(*fixed, *inputs)`` served from one CUDA graph on ``device``.

    ``fixed`` tensors are used where they lie: the graph reads and writes
    them by address, so this object keeps them alive and ``matches`` tells
    a call whose fixed tensors are others.  ``inputs`` go through static
    buffers of their shapes and dtypes (``load``).  ``run`` returns fn's
    outputs as fresh tensors that no later run overwrites (``copy=False``:
    the graph's own memory, for a caller that copies them itself).

    On the card the first ``run`` calls ``fn`` eagerly on a side stream of
    ``device`` under ``torch.cuda.set_sync_debug_mode("error")``, so that
    a host sync raises there with its traceback; there the kernels build,
    K4 opts in to its shared memory on this card and the allocator takes
    the call's buffers.  Its outputs are the run's.  Then ``fn`` is
    captured on that stream (``torch.cuda.graph``'s default capture stream
    lies on the card current at its first use), into ``pool`` (a
    ``torch.cuda.graph_pool_handle()``; a private pool by default).  Later
    runs replay the graph on the card's current stream and copy its
    outputs out.  A failed capture raises; nothing falls back to eager.

    On the CPU ``run`` calls ``fn`` eagerly on the static buffers and
    copies its outputs out: every step but the capture and the replay."""

    def __init__(self, fn, fixed, inputs, *, device, pool=None):
        self.fn = fn
        self.device = torch.device(device)
        self.fixed = list(fixed)
        self._fixed_sig = [_signature(t) for t in self.fixed]
        self._specs = [_spec(x) for x in inputs]
        self.static = [torch.empty(shape, dtype=dtype, device=self.device)
                       for shape, dtype in self._specs]
        self._kept = [None] * len(self.static)
        self.pool = pool
        self.graph = None
        self.out = None
        self.launches = None  # the capture's counts, added at each replay

    def matches(self, fixed, inputs) -> bool:
        """The graph serves ``fixed`` (the same memory) and ``inputs`` (the
        same shapes and dtypes)."""
        return ([_signature(t) for t in fixed] == self._fixed_sig
                and [_spec(x) for x in inputs] == self._specs)

    def load(self, i: int, x, keep: bool = False) -> None:
        """Copy ``x`` into static input ``i``: a tensor on any device, a
        numpy array (through a fresh pinned buffer onto the card: the
        caching host allocator keeps it until the copy has run) or an
        integer.  With ``keep`` the copy is skipped when ``x`` is the input
        copied there last, and a reference to ``x`` is kept, so that its
        memory cannot be reused by another tensor meanwhile."""
        s = self.static[i]
        if keep and _same(self._kept[i], x):
            return
        if isinstance(x, (torch.Tensor, np.ndarray)):
            src = (x if isinstance(x, torch.Tensor)
                   else torch.from_numpy(np.ascontiguousarray(x)))
            if tuple(src.shape) != tuple(s.shape) or src.dtype != s.dtype:
                raise ValueError(f"input {i}: {src.dtype}{list(src.shape)} "
                                 f"for a {s.dtype}{list(s.shape)} buffer")
            pinned = src.device.type == "cpu" and s.device.type == "cuda"
            if pinned:
                src = src.pin_memory()
            profiling.mark_enqueue()
            s.copy_(src, non_blocking=pinned)
        else:
            profiling.mark_enqueue()
            s.fill_(operator.index(x))
        self._kept[i] = x if keep else None

    def run(self, copy: bool = True):
        """``fn``'s outputs on the loaded inputs: fresh tensors, or with
        ``copy=False`` a replay's outputs in the graph's own memory, which
        the next run overwrites (for a caller that copies them itself)."""
        if self.device.type != "cuda":
            with profiling.REPLAY:
                out = self.fn(*self.fixed, *self.static)
        elif self.graph is None:
            profiling.mark_enqueue()
            with profiling.REPLAY:
                return self._capture(copy)
        else:
            profiling.mark_enqueue()
            with profiling.REPLAY:
                self.graph.replay()
                _build.add_counts(self.launches)
                _count_call("replays")
            out = self.out
        if not copy:
            return out
        with profiling.COPY_OUT:
            return _copy_out(out)

    def _capture(self, copy: bool):
        # CUPTI torn down at the end of a torch.profiler window and set up
        # again crashes a process that holds CUDA graphs (torch.profiler
        # turns the teardown off for the graphs of its own compiler the
        # same way); unless the caller chose, keep CUPTI set up
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
        dev = self.device
        with torch.cuda.device(dev):
            cur = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(cur)
            mode = torch.cuda.get_sync_debug_mode()
            with torch.cuda.stream(side):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    first = self.fn(*self.fixed, *self.static)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
            graph = torch.cuda.CUDAGraph()
            tally = (collections.Counter(), collections.Counter())
            # no cyclic garbage collection while capturing: a graph freed
            # from a reference cycle (an engine dropped earlier) is
            # destroyed, which a capture in progress does not permit
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with _build.counting_into(tally), torch.cuda.graph(
                        graph, pool=self.pool, stream=side):
                    out = self.fn(*self.fixed, *self.static)
            finally:
                if gc_on:
                    gc.enable()
            cur.wait_stream(side)
            result = _copy_out(first) if copy else first
            # the eager outputs were made on the side stream: their memory
            # returns to it only once this stream's work on them has run
            _map(lambda t: t.record_stream(cur), first)
        self.graph, self.out, self.launches = graph, out, tally
        _count_call("captures")
        return result


def _eager_copy(x, device):
    """A copy of a graph call's input, as the eager function takes it."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy()).to(device)
    return torch.tensor(operator.index(x), dtype=torch.int32, device=device)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


class EagerTwin:
    """Runs each graph-served call of a ``Renderer`` (its serial entry
    points, ``Renderer._run_graph``) a second time eagerly, as the entry
    points ran before they were graphs: the call's function on copies of
    its fixed tensors and inputs taken before the call (a fused insert
    scatters into the pool).  For tests and the smoke run.

    Each call appends (entry point, gather cap, replayed, equal) to
    ``calls``: ``replayed``, the call replayed a graph captured earlier
    (``calls["replays"]`` rose, no capture); ``equal``, its outputs equal
    the eager ones bit for bit.  With ``keep_eager`` each call's eager
    outputs go to ``eager``.  ``close`` gives the renderer its own method back
    (the wrapper holds the renderer: a reference cycle)."""

    def __init__(self, renderer, keep_eager: bool = False):
        self.renderer = renderer
        self.calls: list[tuple] = []
        self.eager: list = []
        run = renderer._run_graph

        def run_graph(name, cap, fn, fixed, inputs, keep=0):
            fixed_c = [t.clone() for t in fixed]
            inputs_c = [_eager_copy(x, renderer.device) for x in inputs]
            before = collections.Counter(calls)
            out = run(name, cap, fn, fixed, inputs, keep)
            want = fn(*fixed_c, *inputs_c)
            replayed = (calls["replays"] == before["replays"] + 1
                        and calls["captures"] == before["captures"])
            equal = all(torch.equal(_bits(a), _bits(b))
                        for a, b in zip(out, want))
            self.calls.append((name, cap, replayed, equal))
            if keep_eager:
                self.eager.append(want)
            return out

        renderer._run_graph = run_graph

    def replays(self) -> dict:
        """{(entry point, cap): replays}."""
        return collections.Counter((n, c) for n, c, r, _ in self.calls if r)

    def all_replayed_equal(self) -> bool:
        """Every call replayed a graph and equals its eager call."""
        return bool(self.calls) and all(r and e for *_, r, e in self.calls)

    def close(self) -> None:
        self.renderer.__dict__.pop("_run_graph", None)

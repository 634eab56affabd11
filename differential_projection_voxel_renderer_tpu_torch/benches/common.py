"""What the cost probes share: the originals' frame and sizes, a
variant's record, the bytes it must move, bit comparison, and timing on
the card."""

from __future__ import annotations

import json
import statistics
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops import micro
from ..rendering.pipeline import resolve_device

# the originals' frame: 736x1280 (720 rows padded to the tile), 16x128
# tiles two to a grid step, a 98304-record stream
H, W, HEIGHT = 736, 1280, 720
TILE_H, TPS = 16, 2
TK = 98304
N_TILES = H // TILE_H * (W // 128)
N_OCT = TK // 8
BLOCK_Q = micro.BLOCK_Q


def frame_layout(tile_h=TILE_H, tps=TPS,
                 flags=micro.DEPTH | micro.DEPTH_ADD_X, grid2d=False,
                 frame=(H, W)) -> micro.FillLayout:
    """M1 over the frame in tile_h x (128 * tps) tiles, one a grid step in
    row-major order (a 2-D grid of steps with ``grid2d``)."""
    tiles_y, steps_x = frame[0] // tile_h, frame[1] // 128 // tps
    grid = (tiles_y, steps_x) if grid2d else (1, tiles_y * steps_x)
    return micro.FillLayout(tuple(frame), tile_h, 128 * tps, grid,
                            flags=flags, tps=tps)


@dataclass(frozen=True)
class Variant:
    """One probe variant: its kernel ("M1", "M2" or "K2"), the original's
    ``pallas_call`` (file:line), its operands as numpy arrays (``arrays``,
    given the module's inputs), the call on device tensors
    (``run(tensors, plain)`` -> outputs, the plain PyTorch versions when
    ``plain``), the bytes its kernel calls must move, the kernel launches
    a run makes, M1's layout or M2's (mul, add, adds_x) pairs, what of
    the TPU variant has no counterpart, and (launches, bytes) of the torch
    ops a run makes around its kernel calls (the original's array ops
    outside its ``pallas_call``)."""

    kernel: str
    site: str
    arrays: Callable[..., dict]
    run: Callable[[dict, bool], tuple]
    bytes: int
    calls: int = 1
    layout: micro.FillLayout | None = None
    pairs: tuple = ()
    note: str = ""
    torch_ops: tuple = (0, 0)

    def written(self, outs) -> list:
        """The parts of the outputs the kernel writes (M1 may leave rows
        past its tiles unwritten, as the TPU did)."""
        if self.layout is None:
            return list(outs)
        lay = self.layout
        return [o.reshape(lay.view)[:lay.rows_written] for o in outs]


def fill_bytes(layout: micro.FillLayout, has_x: bool = True) -> int:
    """Bytes an M1 fill must move: its written outputs once, x, and what
    its values are read from (order, metadata, record words).  The TPU's
    record stage and metadata copy decided no value: nothing reads them."""
    lay, f = layout, layout.flags
    out = lay.rows_written * lay.view[1] * 4 * (2 if f & micro.DEPTH else 1)
    read = 4 * has_x
    read += 4 * lay.steps * ((f & micro.MAP_ORDER > 0)
                             + 2 * (f & micro.X_FROM_META > 0)
                             + 2 * (f & micro.X_PLUS_REC > 0))
    return out + read


def copy_bytes(rows: int, n_out: int) -> int:
    """Bytes an M2 copy must move: in0 and each output once, and x."""
    return rows * 128 * 4 * (1 + n_out) + 4


def tensors(arrays: dict, device) -> dict:
    """numpy operands as tensors on ``device`` (the card by default in the
    entry points; a missing card raises)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for k, a in arrays.items()}


def same_bits(a, b) -> bool:
    """Two sequences of outputs equal bit for bit (floats as their bits)."""
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(bits(x), bits(y))
        for x, y in zip(a, b))


def need_card():
    if not torch.cuda.is_available():
        raise RuntimeError("timing needs a CUDA device")


def median_ms(fn, reps: int = 20, batch: int = 1) -> float:
    """Median over ``reps`` runs of the CUDA-event time of ``batch``
    back-to-back calls of ``fn``, per call, after one warm-up call (with
    ``batch`` 1 the host's work before the launch counts; a longer batch
    overlaps it with the previous call's device work)."""
    need_card()
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


def host_us(fn, n: int = 50, blocks: int = 5) -> float:
    """Host microseconds of a call: the median over ``blocks`` of the host
    clock around ``n`` calls that are only queued (no synchronisation
    inside), after a warm-up."""
    need_card()
    fn()
    times = []
    for _ in range(blocks):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def graph_ms(fn, calls: int = 30, reps: int = 10) -> float:
    """Device milliseconds of a call with the host out of the way: ``calls``
    calls captured in one CUDA graph, the median over ``reps`` replays
    between CUDA events, per call."""
    need_card()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return statistics.median(times)


def measure(fn) -> dict:
    """A call's times on the card: ``call_ms`` (median of 20 single
    calls), ``run_ms`` (median of 20 runs of 20 back-to-back calls),
    ``queued_ms`` (median of 5 runs of 30 queued calls, the originals' 30
    calls inside one jit), ``host_us`` (host time a call) and ``graph_ms``
    (device time a call, 30 calls replayed from a CUDA graph)."""
    return dict(call_ms=median_ms(fn), run_ms=median_ms(fn, batch=20),
                queued_ms=median_ms(fn, reps=5, batch=30),
                host_us=host_us(fn), graph_ms=graph_ms(fn))


def main_loop(labels, default, time_variant, variant) -> int:
    """Print one JSON line per variant, as the originals do
    (``{"variant": ..., "ms": ...}``, ms = a call of 30 queued), with the
    port's fields: the other times, the kernel, the original's
    pallas_call and the card."""
    need_card()
    name = torch.cuda.get_device_name(0)
    for label in labels or default:
        v = variant(label)
        t = time_variant(label)
        print(json.dumps({"variant": label, "ms": t["queued_ms"], **t,
                          "kernel": v.kernel, "site": v.site,
                          "device": name}), flush=True)
    return 0

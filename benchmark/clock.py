"""When each frame completes.  On a card: a CUDA event recorded after the
entry call on every stream the frame uses (the entry joins its streams
into the current one), read on the device timeline against a start event
recorded right after a ``synchronize()`` at the window's start.  On the
CPU (the tests) the entry is synchronous, so the host clock at its return
is the completion."""

from __future__ import annotations

import time

import torch


class Clock:
    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        self.cuda = self.devices[0].type == "cuda"

    def start(self) -> float:
        """Start the window; returns the host clock at its start."""
        if self.cuda:
            for d in self.devices:
                torch.cuda.synchronize(d)
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.devices[0]))
        self.t0 = time.perf_counter()
        return self.t0

    def mark(self):
        """A mark that completes after everything issued so far."""
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.devices[0]))
        return ev

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def seconds(self, mark) -> float:
        """Seconds from the window's start to ``mark``'s completion."""
        if not self.cuda:
            return mark - self.t0
        return self._start.elapsed_time(mark) / 1e3

    def finish(self) -> None:
        if self.cuda:
            for d in self.devices:
                torch.cuda.synchronize(d)

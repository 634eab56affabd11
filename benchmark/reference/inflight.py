"""The plain model of frames in flight: which frame each call emits.

A program with one frame in flight enters one frame a call and returns
the frame entered before it: call ``k`` emits frame ``k - 1`` (the first
call of an empty pipeline emits nothing), whether the carried frame is
rendered by the step that works out frame ``k``'s stage A (the same
gather bucket) or drained first because frame ``k`` takes another bucket.
A flush emits the last frame entered and empties the pipeline; a flush of
an empty pipeline emits nothing.  Plain Python; nothing of the port."""

from __future__ import annotations


def emissions(buckets, flushes: int = 1):
    """The model's answer for calls that enter frames of gather buckets
    ``buckets`` (one a call, in order) on an empty pipeline, then
    ``flushes`` flushes: (per call the frame it emits or None, per flush
    the frame it emits or None, the calls whose carried frame is drained
    because the bucket changed)."""
    calls = [k - 1 if k else None for k in range(len(buckets))]
    flushed = [len(buckets) - 1 if buckets and not j else None
               for j in range(flushes)]
    drained = [k for k in range(1, len(buckets))
               if buckets[k] != buckets[k - 1]]
    return calls, flushed, drained


def order_diff(buckets, emitted, flushed) -> int:
    """Emitted frames missing, doubled or out of order against the model:
    ``emitted`` says of each call, ``flushed`` of each flush after the
    calls, whether it returned a frame.  The run's emissions are its
    frames in the order they came out (the program promises that order),
    each set beside the call or flush at which the model emits that frame;
    every emission at another place, and every frame too many or too few,
    counts one."""
    want_calls, want_flushed, _ = emissions(buckets, len(flushed))
    want = ([("call", k) for k, f in enumerate(want_calls) if f is not None]
            + [("flush", j) for j, f in enumerate(want_flushed)
               if f is not None])
    got = ([("call", k) for k, e in enumerate(emitted) if e]
           + [("flush", j) for j, e in enumerate(flushed) if e])
    return (sum(a != b for a, b in zip(got, want))
            + abs(len(got) - len(want)))

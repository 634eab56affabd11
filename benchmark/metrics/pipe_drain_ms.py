"""Host ms a frame in the program's ``pipe_drain`` span (a carried frame
drained serially, with the seed's stage A after it; their graphs' loads,
replays and copies in it), mean over the traced window's unprofiled
frames.  None where the program has no such span."""

from ..program import span_ms


def read(ctx):
    try:
        return span_ms(ctx, "pipe_drain")
    except ValueError:  # a tracer without the span
        return None

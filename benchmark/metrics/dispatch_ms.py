"""Host ms a frame in the program's ``dispatch`` span, the renderer's
entry call (packing, the graph's input loads, its replay and the copy of
its outputs), mean over the traced window's unprofiled frames."""

from ..program import span_ms


def read(ctx):
    return span_ms(ctx, "dispatch")

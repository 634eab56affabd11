"""Host ms a frame in the program's ``dispatch`` span in a frames-in-flight
cell: the renderer's pipelined call (packing, the graph's input loads,
its replay, the copy of its outputs, and any drain), mean over the traced
window's unprofiled frames."""

from ..program import span_ms


def read(ctx):
    return span_ms(ctx, "dispatch")

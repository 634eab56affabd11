"""Host ms a frame in the program's ``world_update`` span
(``World.update``: the missing-chunk queue, chunk generation, unloads),
mean over the traced window's unprofiled frames."""

from ..program import span_ms


def read(ctx):
    return span_ms(ctx, "world_update")

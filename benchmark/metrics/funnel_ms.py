"""Host ms a frame in the program's ``funnel`` span less its children
(``world_update``, ``meshing``): the visibility query, slot lookup, sort,
horizon cull, direction masks and draw-list signature of
``Engine._funnel``, mean over the traced window's unprofiled frames."""

from ..program import span_ms


def read(ctx):
    return span_ms(ctx, "funnel", self_time=True)

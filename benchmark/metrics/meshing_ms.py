"""Host ms a frame in the program's ``meshing`` span
(``Engine._mesh_list`` and below: the mesher, the insert payload or the
eager pool scatter), mean over the traced window's unprofiled frames."""

from ..program import span_ms


def read(ctx):
    return span_ms(ctx, "meshing")

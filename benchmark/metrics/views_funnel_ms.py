"""Host ms a call in the program's ``funnel`` spans of every view
(``Engine.render_views`` runs the funnel once a view; its children, the
world's update and the meshing, are in), mean over the traced window's
unprofiled calls."""

from ..program import span_ms


def read(ctx):
    return span_ms(ctx, "funnel")

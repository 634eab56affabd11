"""Host ms a call in the program's ``views_dispatch`` span: the sharded
render of the views (the replicas and inputs loaded, every card's graph
replayed, the all-reduce, the gather), mean over the traced window's
unprofiled calls.  None where the program has no such span."""

from ..program import span_ms


def read(ctx):
    try:
        return span_ms(ctx, "views_dispatch")
    except ValueError:  # a tracer without the views spans
        return None

"""Device ms a call of the peer copies (``Memcpy PtoP``: the gather of
the other cards' bands and stats into the first card), summed over the
copies, in the profiled calls."""

from . import kernel_us, per_frame


def read(ctx):
    return per_frame(ctx, kernel_us(ctx, "Memcpy PtoP"))

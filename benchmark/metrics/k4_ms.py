"""K4's (``raster_packed_kernel``) device ms a frame in the profiled
frames."""

from . import kernel_us, per_frame


def read(ctx):
    return per_frame(ctx, kernel_us(ctx, "raster_packed_kernel"))

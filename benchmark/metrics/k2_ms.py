"""K2's (``raster_kernel``) device ms a frame in the profiled frames."""

from . import kernel_us, per_frame


def read(ctx):
    return per_frame(ctx, kernel_us(ctx, "raster_kernel",
                                    exclude=("raster_packed",)))

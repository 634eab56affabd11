"""The tile_meta kernel's (``tile_meta_kernel``: the default binning's
record gather and octet metadata) device ms a frame in the profiled
frames."""

from . import kernel_us, per_frame


def read(ctx):
    return per_frame(ctx, kernel_us(ctx, "tile_meta_kernel"))

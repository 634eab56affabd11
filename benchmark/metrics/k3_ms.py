"""K3's device ms a frame in the profiled frames: ``raster_kernel``, which
on the frames-in-flight path is the raster with the next frame's stage A
(K3), and K2 in a drain's serial step (``pipe_drains`` says how many)."""

from . import kernel_us, per_frame


def read(ctx):
    return per_frame(ctx, kernel_us(ctx, "raster_kernel",
                                    exclude=("raster_packed",)))

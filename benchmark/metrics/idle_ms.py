"""Card idle ms a frame on the card's own clock, between the program's
markers where it enqueued nothing, counted from the previous frame's end
(so the time between frames is in), mean over the traced window's
unprofiled frames."""

from ..program import idle_ms


def read(ctx):
    return idle_ms(ctx, "idle")

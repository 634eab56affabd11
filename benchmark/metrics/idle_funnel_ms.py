"""Card idle ms a frame while the host was in the program's ``funnel``
(frame start to dispatch start, less eager device work), on the card's
clock, mean over the traced window's unprofiled frames."""

from ..program import idle_ms


def read(ctx):
    return idle_ms(ctx, "idle_funnel")

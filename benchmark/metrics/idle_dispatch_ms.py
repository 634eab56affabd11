"""Card idle ms a frame while the host was in the program's ``dispatch``
before its first enqueue, on the card's clock, mean over the traced
window's unprofiled frames."""

from ..program import idle_ms


def read(ctx):
    return idle_ms(ctx, "idle_dispatch")

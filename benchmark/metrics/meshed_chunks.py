"""Chunks meshed a frame, by the program's counter ``chunks_meshed`` (each
loaded chunk the engine meshes), mean over the traced window's unprofiled
frames."""

from ..program import count


def read(ctx):
    return count(ctx, "chunks_meshed")

"""Chunks meshed a frame, counted by the harness's wrapper of the engine's
meshing call over the traced window's unprofiled frames."""


def read(ctx):
    s = ctx["spans"]
    if not s or not s.frames or not s.counts["meshing"]:
        return None
    return s.counts["meshing"] / s.frames

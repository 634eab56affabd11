"""Host ms a frame inside the world's ``update`` and the engine's meshing
call, mean over the traced window's unprofiled frames."""


def read(ctx):
    s = ctx["spans"]
    if not s or not s.frames or not s.calls["meshing"]:
        return None
    return (s.ms["world_update"] + s.ms["meshing"]) / s.frames

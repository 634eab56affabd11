"""Host ms a frame inside the entry call (``Engine.render_frame``), host
clock around the call, mean over the traced window's unprofiled frames."""


def read(ctx):
    s = ctx["spans"]
    if not s or not s.frames or not s.calls["entry"]:
        return None
    return s.ms["entry"] / s.frames

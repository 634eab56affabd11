"""Faults planted under the timed path, to show that the comparison sees
them: each takes the cell's runner, breaks the engine it drives from the
outside (planting a fault may reach into the engine; judging never does)
and returns the call that takes the fault out again, so that each fault
is read alone."""

from __future__ import annotations

BLOCK = 64


def _swap(obj, attr: str, new):
    """Set ``obj.attr`` to ``new``; returns the undo."""
    had = attr in vars(obj)
    old = vars(obj).get(attr)
    setattr(obj, attr, new)

    def undo():
        if had:
            setattr(obj, attr, old)
        else:
            delattr(obj, attr)

    return undo


def altered_pixels(cell):
    """An answer altered where it is produced: every frame's colour has a
    64 x 64 block of its middle inverted."""
    orig = cell.eng.render_frame

    def render_frame(*a, **kw):
        res = orig(*a, **kw)
        h, w = res.color.shape[-2:]
        res.color[..., h // 2:h // 2 + BLOCK, w // 2:w // 2 + BLOCK] ^= (
            0x00FFFFFF)
        return res

    return _swap(cell.eng, "render_frame", render_frame)


def half_drawlist(cell):
    """Half of the batch left out: the second half of every frame's draw
    list gets no quads (its chunks' counts and masks zeroed)."""
    eng = cell.eng
    orig = eng._funnel

    def funnel(dt):
        out = orig(dt)
        n = int(eng._last_n_visible)
        eng._last_counts_sel = eng._last_counts_sel.copy()
        eng._last_counts_sel[n // 2:n] = 0
        eng._last_dir_mask = eng._last_dir_mask.copy()
        eng._last_dir_mask[n // 2:n] = 0
        vp, sig, *rest = out
        return (vp, (sig, "half"), *rest)

    return _swap(eng, "_funnel", funnel)


def altered_mesh(cell):
    """A mesh altered where it is produced: the first quad of every pooled
    mesh moves 16 slices along its normal."""
    quads = cell.eng.pool.quads

    def flip():
        quads[:, 0] ^= 1 << 28

    flip()
    return flip


FAULTS = {"altered_pixels": altered_pixels, "half_drawlist": half_drawlist,
          "altered_mesh": altered_mesh}
